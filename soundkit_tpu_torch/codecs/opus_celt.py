"""RFC 6716 §4.3 CELT layer decoder (owned code, no libopus).

Covers the full normative decode chain: coarse/fine band energy
(Laplace + raw bits), tf_change, spread, dynalloc boosts, the bit
allocation interpolation with skip/intensity/dual-stereo decisions,
PVQ band decode with theta splitting, Hadamard recombining, spreading
rotation and folding, anti-collapse, denormalization, low-overlap
inverse MDCT, comb postfilter and de-emphasis.

Data tables come from the extracted RFC set (opus_tables.py); the
synthesis runs at the native 48 kHz grid for every CELT bandwidth.
Parity reference: soundkit-opus/src/lib.rs (libopus wrapper).
"""
from __future__ import annotations

import math

import numpy as np

from soundkit_tpu_torch.codecs.opus_rc import RangeDecoder, laplace_decode, ilog
from soundkit_tpu_torch.codecs.opus_tables import tables, PVQ_U_ROW_OFFSETS

BITRES = 3
MAX_FINE_BITS = 8
FINE_OFFSET = 21
ALLOC_STEPS = 6
NB_BANDS = 21
OVERLAP = 120
SPREAD_NONE, SPREAD_LIGHT, SPREAD_NORMAL, SPREAD_AGGRESSIVE = 0, 1, 2, 3
COMBFILTER_MINPERIOD = 15
# de-emphasis pole: the float build uses the Q15 constant 27853/32768,
# not 0.85 exactly
CELT_EMPH_COEFF = 27853.0 / 32768.0

_ORDERY = {
    2: (1, 0),
    4: (3, 0, 2, 1),
    8: (7, 0, 4, 3, 6, 1, 5, 2),
    16: (15, 0, 8, 7, 12, 3, 11, 4, 14, 1, 9, 6, 13, 2, 10, 5),
}


def _lcg(seed: int) -> int:
    return (seed * 1664525 + 1013904223) & 0xFFFFFFFF


def _sdiv(a: int, b: int) -> int:
    """C-style signed integer division (truncate toward zero)."""
    q = abs(a) // abs(b)
    return -q if (a < 0) != (b < 0) else q


def _isqrt(v: int) -> int:
    return math.isqrt(v)


def _frac_mul16(a: int, b: int) -> int:
    return (16384 + a * b) >> 15


def _bitexact_cos(x: int) -> int:
    tmp = (4096 + x * x) >> 13
    x2 = tmp
    x2 = (32767 - x2) + _frac_mul16(
        x2, -7651 + _frac_mul16(x2, 8277 + _frac_mul16(-626, x2))
    )
    return 1 + x2


def _bitexact_log2tan(isin: int, icos: int) -> int:
    lc = ilog(icos)
    ls = ilog(isin)
    icos <<= 15 - lc
    isin <<= 15 - ls
    return (
        (ls - lc) * (1 << 11)
        + _frac_mul16(isin, _frac_mul16(isin, -2597) + 7932)
        - _frac_mul16(icos, _frac_mul16(icos, -2597) + 7932)
    )


class _PVQ:
    """V(N,K) codeword enumeration over the RFC's U(n,k) recurrence."""

    def __init__(self, u_flat: np.ndarray):
        self._rows = [
            u_flat[off:].astype(np.uint64) for off in PVQ_U_ROW_OFFSETS
        ]

    def U(self, n: int, k: int) -> int:
        lo, hi = (n, k) if n < k else (k, n)
        if lo >= len(self._rows):
            raise ValueError("pvq row out of range")
        return int(self._rows[lo][hi])

    def V(self, n: int, k: int) -> int:
        return self.U(n, k) + self.U(n, k + 1)

    def cwrsi(self, n: int, k: int, i: int) -> np.ndarray:
        y = np.zeros(n, dtype=np.int64)
        pos = 0
        while n > 2:
            if k >= n:
                row = self._rows[n]
                p = int(row[k + 1])
                s = -1 if i >= p else 0
                if s:
                    i -= p
                k0 = k
                q = int(row[n])
                if q > i:
                    k = n
                    while True:
                        k -= 1
                        p = int(self._rows[k][n])
                        if p <= i:
                            break
                else:
                    p = int(row[k])
                    while p > i:
                        k -= 1
                        p = int(row[k])
                i -= p
                val = (k0 - k + s) ^ s
                y[pos] = val
                pos += 1
            else:
                p = int(self._rows[k][n])
                q = int(self._rows[k + 1][n])
                if p <= i < q:
                    i -= p
                    y[pos] = 0
                    pos += 1
                else:
                    s = -1 if i >= q else 0
                    if s:
                        i -= q
                    k0 = k
                    while True:
                        k -= 1
                        p = int(self._rows[k][n])
                        if p <= i:
                            break
                    i -= p
                    val = (k0 - k + s) ^ s
                    y[pos] = val
                    pos += 1
            n -= 1
        # n == 2
        p = 2 * k + 1
        s = -1 if i >= p else 0
        if s:
            i -= p
        k0 = k
        k = (i + 1) >> 1
        if k:
            i -= 2 * k - 1
        y[pos] = (k0 - k + s) ^ s
        pos += 1
        # n == 1
        s = -int(i)
        y[pos] = (k + s) ^ s
        return y


def _get_pulses(i: int) -> int:
    return i if i < 8 else (8 + (i & 7)) << ((i >> 3) - 1)


def _haar1(X: np.ndarray, n0: int, stride: int) -> None:
    n0 >>= 1
    s = 1.0 / math.sqrt(2.0)
    for i in range(stride):
        idx1 = stride * 2 * np.arange(n0) + i
        idx2 = idx1 + stride
        t1 = s * X[idx1]
        t2 = s * X[idx2]
        X[idx1] = t1 + t2
        X[idx2] = t1 - t2


def _deinterleave_hadamard(X: np.ndarray, n0: int, stride: int,
                           hadamard: bool) -> None:
    n = n0 * stride
    tmp = np.empty(n, dtype=X.dtype)
    if hadamard:
        ordery = _ORDERY[stride]
        for i in range(stride):
            tmp[ordery[i] * n0 : ordery[i] * n0 + n0] = X[i:n:stride]
    else:
        for i in range(stride):
            tmp[i * n0 : i * n0 + n0] = X[i:n:stride]
    X[:n] = tmp


def _interleave_hadamard(X: np.ndarray, n0: int, stride: int,
                         hadamard: bool) -> None:
    n = n0 * stride
    tmp = np.empty(n, dtype=X.dtype)
    if hadamard:
        ordery = _ORDERY[stride]
        for i in range(stride):
            tmp[i:n:stride] = X[ordery[i] * n0 : ordery[i] * n0 + n0]
    else:
        for i in range(stride):
            tmp[i:n:stride] = X[i * n0 : i * n0 + n0]
    X[:n] = tmp


def _exp_rotation1(X: np.ndarray, length: int, stride: int,
                   c: float, s: float) -> None:
    ms = -s
    for i in range(length - stride):
        x1 = X[i]
        x2 = X[i + stride]
        X[i + stride] = c * x2 + s * x1
        X[i] = c * x1 + ms * x2
    for i in range(length - 2 * stride - 1, -1, -1):
        x1 = X[i]
        x2 = X[i + stride]
        X[i + stride] = c * x2 + s * x1
        X[i] = c * x1 + ms * x2


def _exp_rotation(X: np.ndarray, length: int, direction: int, stride: int,
                  K: int, spread: int) -> None:
    factors = (None, 15, 10, 5)
    if 2 * K >= length or spread == SPREAD_NONE:
        return
    factor = factors[spread]
    gain = 1.0 * length / (length + factor * K)
    theta = 0.5 * gain * gain
    c = math.cos(0.5 * math.pi * theta)
    s = math.cos(0.5 * math.pi * (1.0 - theta))
    stride2 = 0
    if length >= 8 * stride:
        stride2 = 1
        while (stride2 * stride2 + stride2) * stride + (stride >> 2) < length:
            stride2 += 1
    length //= stride
    for i in range(stride):
        seg = X[i * length : (i + 1) * length]
        if direction < 0:
            if stride2:
                _exp_rotation1(seg, length, stride2, s, c)
            _exp_rotation1(seg, length, 1, c, s)
        else:
            _exp_rotation1(seg, length, 1, c, -s)
            if stride2:
                _exp_rotation1(seg, length, stride2, s, -c)


def _renormalise(X: np.ndarray, gain: float = 1.0) -> None:
    e = float(np.dot(X, X))
    if e > 0:
        X *= gain / math.sqrt(e)


def _extract_collapse_mask(iy: np.ndarray, N: int, B: int) -> int:
    if B <= 1:
        return 1
    n0 = N // B
    mask = 0
    for i in range(B):
        if np.any(iy[i * n0 : (i + 1) * n0] != 0):
            mask |= 1 << i
    return mask


class CeltDecoder:
    """Stateful CELT layer for one stream (mono or stereo)."""

    def __init__(self, channels: int):
        t = tables()
        self.t = t
        self.pvq = _PVQ(t["celt_pvq_u"])
        self.channels = channels
        self.eBands = t["celt_freq_bands"].astype(int)
        self.logN = t["celt_log_freq_range"].astype(int)
        self.window = t["celt_window"].astype(np.float64)
        self.eMeans = t["celt_mean_energy"].astype(np.float64)
        self.alpha_coef = t["celt_alpha_coef"].astype(np.float64)
        self.beta_coef = t["celt_beta_coef"].astype(np.float64)
        self.e_prob = t["celt_coarse_energy_dist"].astype(int)
        self.static_alloc = t["celt_static_alloc"].astype(int)
        self.static_caps = t["celt_static_caps"].astype(int)
        self.cache_index = t["celt_cache_index"].astype(int)
        self.cache_bits = t["celt_cache_bits"].astype(int)
        self.log2_frac = t["celt_log2_frac"].astype(int)
        self.tf_select_tab = t["celt_tf_select"].astype(int)
        self.qn_exp2 = t["celt_qn_exp2"].astype(int)
        self.bit_interleave = t["celt_bit_interleave"].astype(int)
        self.bit_deinterleave = t["celt_bit_deinterleave"].astype(int)
        self.pf_taps = t["celt_postfilter_taps"].astype(np.float64)
        self.spread_icdf = t["celt_model_spread"]
        self.tapset_icdf = t["celt_model_tapset"]
        self.trim_icdf = t["celt_model_alloc_trim"]
        self.energy_small = t["celt_model_energy_small"]
        self.reset()

    def reset(self) -> None:
        C = self.channels
        self.oldE = np.zeros((C, NB_BANDS))
        self.oldLogE = np.full((C, NB_BANDS), -28.0)
        self.oldLogE2 = np.full((C, NB_BANDS), -28.0)
        self.rng = 0
        self.preemph_mem = np.zeros(C)
        self.hist = np.zeros((C, 4096))  # synthesis history (postfilter+OLA)
        self.ola = np.zeros((C, OVERLAP))  # pending overlap tail
        self.pf_period = 15
        self.pf_period_old = 15
        self.pf_gain = 0.0
        self.pf_gain_old = 0.0
        self.pf_tapset = 0
        self.pf_tapset_old = 0

    # -- energy ----------------------------------------------------------
    def _coarse_energy(self, rc: RangeDecoder, start: int, end: int,
                       intra: bool, LM: int, C: int = 0) -> None:
        C = C or self.channels
        prob = self.e_prob[LM][1 if intra else 0]
        # the extracted beta table is pre-complemented (stores 1-beta),
        # so the inter-band accumulator is prev += beta_table * q
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
                tell = rc.tell()
                if budget - tell >= 15:
                    pi = 2 * min(i, 20)
                    qi = laplace_decode(rc, int(prob[pi]) << 7,
                                        int(prob[pi + 1]) << 6)
                elif budget - tell >= 2:
                    qi = rc.dec_cdf(self.energy_small)
                    qi = (qi >> 1) ^ -(qi & 1)
                elif budget - tell >= 1:
                    qi = -rc.dec_bit_logp(1)
                else:
                    qi = -1
                q = float(qi)
                tmp = coef * max(-9.0, self.oldE[c, i]) + prev[c] + q
                self.oldE[c, i] = tmp
                prev[c] = prev[c] + beta * q

    def _fine_energy(self, rc: RangeDecoder, start: int, end: int,
                     fine_quant, C: int = 0) -> None:
        C = C or self.channels
        for i in range(start, end):
            if fine_quant[i] <= 0:
                continue
            for c in range(C):
                q2 = rc.rawbits(fine_quant[i])
                self.oldE[c, i] += (q2 + 0.5) / (1 << fine_quant[i]) - 0.5

    def _finalize_energy(self, rc: RangeDecoder, start: int, end: int,
                         fine_quant, fine_priority, bits_left: int,
                         C: int = 0) -> None:
        C = C or self.channels
        for prio in (0, 1):
            i = start
            while i < end and bits_left >= C:
                if fine_quant[i] >= MAX_FINE_BITS or fine_priority[i] != prio:
                    i += 1
                    continue
                for c in range(C):
                    q2 = rc.rawbits(1)
                    self.oldE[c, i] += (q2 - 0.5) / (1 << (fine_quant[i] + 1))
                bits_left -= C
                i += 1

    # -- allocation --------------------------------------------------------
    def _bits2pulses(self, band: int, LM: int, bits: int) -> int:
        off = self.cache_index[(LM + 1) * NB_BANDS + band]
        cache = self.cache_bits[off:]
        lo, hi = 0, int(cache[0])
        bits -= 1
        for _ in range(6):
            mid = (lo + hi + 1) >> 1
            if int(cache[mid]) >= bits:
                hi = mid
            else:
                lo = mid
        lo_val = -1 if lo == 0 else int(cache[lo])
        if bits - lo_val <= int(cache[hi]) - bits:
            return lo
        return hi

    def _pulses2bits(self, band: int, LM: int, pulses: int) -> int:
        off = self.cache_index[(LM + 1) * NB_BANDS + band]
        cache = self.cache_bits[off:]
        return 0 if pulses == 0 else int(cache[pulses]) + 1

    def _interp_bits2pulses(self, start, end, skip_start, bits1, bits2,
                            thresh, cap, total, skip_rsv, intensity_rsv,
                            dual_stereo_rsv, rc: RangeDecoder, LM, C=0):
        C = C or self.channels
        eBands = self.eBands
        alloc_floor = C << BITRES
        stereo = 1 if C > 1 else 0
        logM = LM << BITRES
        bits = np.zeros(NB_BANDS, dtype=np.int64)
        ebits = np.zeros(NB_BANDS, dtype=np.int64)
        fine_priority = np.zeros(NB_BANDS, dtype=np.int64)

        lo, hi = 0, 1 << ALLOC_STEPS
        for _ in range(ALLOC_STEPS):
            mid = (lo + hi) >> 1
            psum = 0
            done = False
            for j in range(end - 1, start - 1, -1):
                tmp = bits1[j] + ((mid * bits2[j]) >> ALLOC_STEPS)
                if tmp >= thresh[j] or done:
                    done = True
                    psum += min(tmp, cap[j])
                elif tmp >= alloc_floor:
                    psum += alloc_floor
            if psum > total:
                hi = mid
            else:
                lo = mid
        psum = 0
        done = False
        for j in range(end - 1, start - 1, -1):
            tmp = bits1[j] + ((lo * bits2[j]) >> ALLOC_STEPS)
            if tmp < thresh[j] and not done:
                tmp = alloc_floor if tmp >= alloc_floor else 0
            else:
                done = True
            tmp = min(tmp, cap[j])
            bits[j] = tmp
            psum += tmp

        codedBands = end
        while True:
            j = codedBands - 1
            if j <= skip_start:
                total += skip_rsv
                break
            left = total - psum
            percoeff = left // (eBands[codedBands] - eBands[start])
            left -= (eBands[codedBands] - eBands[start]) * percoeff
            rem = max(left - (eBands[j] - eBands[start]), 0)
            band_width = eBands[codedBands] - eBands[j]
            band_bits = int(bits[j] + percoeff * band_width + rem)
            if band_bits >= max(thresh[j], alloc_floor + (1 << BITRES)):
                if rc.dec_bit_logp(1):
                    break
                psum += 1 << BITRES
                band_bits -= 1 << BITRES
            psum -= bits[j] + intensity_rsv
            if intensity_rsv > 0:
                intensity_rsv = self.log2_frac[j - start]
            psum += intensity_rsv
            if band_bits >= alloc_floor:
                psum += alloc_floor
                bits[j] = alloc_floor
            else:
                bits[j] = 0
            codedBands -= 1

        if intensity_rsv > 0:
            intensity = start + rc.dec_uint(codedBands + 1 - start)
        else:
            intensity = 0
        if intensity <= start:
            total += dual_stereo_rsv
            dual_stereo_rsv = 0
        dual_stereo = rc.dec_bit_logp(1) if dual_stereo_rsv > 0 else 0

        left = total - psum
        percoeff = left // (eBands[codedBands] - eBands[start])
        left -= (eBands[codedBands] - eBands[start]) * percoeff
        for j in range(start, codedBands):
            bits[j] += percoeff * (eBands[j + 1] - eBands[j])
        for j in range(start, codedBands):
            tmp = min(left, eBands[j + 1] - eBands[j])
            bits[j] += tmp
            left -= tmp

        balance = 0
        for j in range(start, codedBands):
            N0 = eBands[j + 1] - eBands[j]
            N = N0 << LM
            bit = int(bits[j]) + balance
            if N > 1:
                excess = max(bit - cap[j], 0)
                bits[j] = bit - excess
                den = C * N + (
                    1 if (C == 2 and N > 2 and not dual_stereo
                          and j < intensity) else 0
                )
                NClogN = den * (self.logN[j] + logM)
                offset = (NClogN >> 1) - den * FINE_OFFSET
                if N == 2:
                    offset += den << BITRES >> 2
                if bits[j] + offset < (den * 2) << BITRES:
                    offset += NClogN >> 2
                elif bits[j] + offset < (den * 3) << BITRES:
                    offset += NClogN >> 3
                ebits[j] = max(
                    0, int(bits[j] + offset + (den << (BITRES - 1)))
                ) // (den << BITRES)
                if C * ebits[j] << BITRES > bits[j]:
                    ebits[j] = int(bits[j]) >> stereo >> BITRES
                ebits[j] = min(ebits[j], MAX_FINE_BITS)
                fine_priority[j] = (
                    1 if ebits[j] * (den << BITRES) >= bits[j] + offset else 0
                )
                bits[j] -= C * ebits[j] << BITRES
            else:
                excess = max(bit - (C << BITRES), 0)
                bits[j] = bit - excess
                ebits[j] = 0
                fine_priority[j] = 1
            if excess > 0:
                extra_fine = min(
                    excess >> (stereo + BITRES), MAX_FINE_BITS - ebits[j]
                )
                ebits[j] += extra_fine
                extra_bits = extra_fine * C << BITRES
                fine_priority[j] = 1 if extra_bits >= excess - balance else 0
                excess -= extra_bits
            balance = excess
        for j in range(codedBands, end):
            ebits[j] = int(bits[j]) >> stereo >> BITRES
            bits[j] = 0
            fine_priority[j] = 1 if ebits[j] < 1 else 0
        return (bits, ebits, fine_priority, codedBands, balance,
                intensity, dual_stereo)

    def _compute_allocation(self, start, end, offsets, cap, alloc_trim,
                            total, rc: RangeDecoder, LM, C=0):
        C = C or self.channels
        eBands = self.eBands
        total = max(total, 0)
        skip_start = start
        skip_rsv = (1 << BITRES) if total >= (1 << BITRES) else 0
        total -= skip_rsv
        intensity_rsv = dual_stereo_rsv = 0
        if C == 2:
            intensity_rsv = int(self.log2_frac[end - start])
            if intensity_rsv > total:
                intensity_rsv = 0
            else:
                total -= intensity_rsv
                dual_stereo_rsv = (1 << BITRES) if total >= (1 << BITRES) else 0
                total -= dual_stereo_rsv
        thresh = np.zeros(NB_BANDS, dtype=np.int64)
        trim_offset = np.zeros(NB_BANDS, dtype=np.int64)
        for j in range(start, end):
            thresh[j] = max(
                C << BITRES,
                (3 * (eBands[j + 1] - eBands[j]) << LM << BITRES) >> 4,
            )
            trim_offset[j] = (
                C * (eBands[j + 1] - eBands[j])
                * (alloc_trim - 5 - LM) * (end - j - 1)
                * (1 << (LM + BITRES))
            ) >> 6
            if (eBands[j + 1] - eBands[j]) << LM == 1:
                trim_offset[j] -= C << BITRES
        lo, hi = 1, self.static_alloc.shape[0] - 1
        while lo <= hi:
            mid = (lo + hi) >> 1
            psum = 0
            done = False
            for j in range(end - 1, start - 1, -1):
                bitsj = (
                    C * (eBands[j + 1] - eBands[j])
                    * int(self.static_alloc[mid, j]) << LM
                ) >> 2
                if bitsj > 0:
                    bitsj = max(0, bitsj + int(trim_offset[j]))
                bitsj += int(offsets[j])
                if bitsj >= thresh[j] or done:
                    done = True
                    psum += min(bitsj, int(cap[j]))
                elif bitsj >= C << BITRES:
                    psum += C << BITRES
            if psum > total:
                hi = mid - 1
            else:
                lo = mid + 1
        hi = lo
        lo -= 1
        bits1 = np.zeros(NB_BANDS, dtype=np.int64)
        bits2 = np.zeros(NB_BANDS, dtype=np.int64)
        for j in range(start, end):
            N = eBands[j + 1] - eBands[j]
            b1 = (C * N * int(self.static_alloc[lo, j]) << LM) >> 2
            b2 = (
                int(cap[j]) if hi >= self.static_alloc.shape[0]
                else (C * N * int(self.static_alloc[hi, j]) << LM) >> 2
            )
            if b1 > 0:
                b1 = max(0, b1 + int(trim_offset[j]))
            if b2 > 0:
                b2 = max(0, b2 + int(trim_offset[j]))
            if lo > 0:
                b1 += int(offsets[j])
            b2 += int(offsets[j])
            if offsets[j] > 0:
                skip_start = j
            b2 = max(0, b2 - b1)
            bits1[j] = b1
            bits2[j] = b2
        return self._interp_bits2pulses(
            start, end, skip_start, bits1, bits2, thresh, cap, total,
            skip_rsv, intensity_rsv, dual_stereo_rsv, rc, LM, C,
        )

    # -- PVQ band decode ---------------------------------------------------
    def _alg_unquant(self, X: np.ndarray, N: int, K: int, spread: int,
                     B: int, rc: RangeDecoder, gain: float) -> int:
        idx = rc.dec_uint(self.pvq.V(N, K))
        iy = self.pvq.cwrsi(N, K, idx)
        Ryy = float(np.dot(iy, iy))
        X[:N] = iy * (gain / math.sqrt(Ryy))
        _exp_rotation(X[:N], N, -1, B, K, spread)
        return _extract_collapse_mask(iy, N, B)

    def _compute_qn(self, N: int, b: int, offset: int, pulse_cap: int,
                    stereo: bool) -> int:
        N2 = 2 * N - 1
        if stereo and N == 2:
            N2 -= 1
        qb = _sdiv(b + N2 * offset, N2)
        qb = min(b - pulse_cap - (4 << BITRES), qb)
        qb = min(8 << BITRES, qb)
        if qb < (1 << BITRES >> 1):
            return 1
        qn = int(self.qn_exp2[qb & 0x7]) >> (14 - (qb >> BITRES))
        return ((qn + 1) >> 1) << 1

    def _quant_partition(self, ctx, X: np.ndarray, N: int, b: int, B: int,
                         lowband, LM: int, gain: float, fill: int) -> int:
        band = ctx["band"]
        off = self.cache_index[(LM + 1) * NB_BANDS + band]
        cache = self.cache_bits[off:]
        if LM != -1 and b > int(cache[int(cache[0])]) + 12 and N > 2:
            B0 = B  # entry-level B of THIS partition
            N >>= 1
            Y = X[N:]
            LM -= 1
            if B == 1:
                fill = (fill & 1) | (fill << 1)
            B = (B + 1) >> 1
            itheta, delta, fill, qalloc, _inv = self._compute_theta(
                ctx, N, b, B, B0, LM, fill
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
            # transient-frame bias toward the weaker MDCT (pre-echo /
            # forward-masking correction)
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
                cm = self._quant_partition(
                    ctx, X, N, mbits, B, lowband, LM, gain * mid, fill
                )
                rebalance = mbits - (rebalance - ctx["remaining_bits"])
                if rebalance > 3 << BITRES and itheta != 0:
                    sbits += rebalance - (3 << BITRES)
                next_lb = lowband[N:] if lowband is not None else None
                cm |= self._quant_partition(
                    ctx, Y, N, sbits, B, next_lb, LM, gain * side,
                    fill >> B,
                ) << (B0 >> 1)
            else:
                next_lb = lowband[N:] if lowband is not None else None
                cm = self._quant_partition(
                    ctx, Y, N, sbits, B, next_lb, LM, gain * side,
                    fill >> B,
                ) << (B0 >> 1)
                rebalance = sbits - (rebalance - ctx["remaining_bits"])
                if rebalance > 3 << BITRES and itheta != 16384:
                    mbits += rebalance - (3 << BITRES)
                cm |= self._quant_partition(
                    ctx, X, N, mbits, B, lowband, LM, gain * mid, fill
                )
            return cm
        # leaf: PVQ or folding
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
            return self._alg_unquant(X, N, K, ctx["spread"], B,
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

    def _compute_theta(self, ctx, N: int, b: int, B: int, B0: int,
                       LM: int, fill: int, stereo: bool = False):
        rc: RangeDecoder = ctx["rc"]
        band = ctx["band"]
        pulse_cap = self.logN[band] + LM * (1 << BITRES)
        # QTHETA_OFFSET = 4; QTHETA_OFFSET_TWOPHASE = 16
        offset = (pulse_cap >> 1) - (16 if (stereo and N == 2) else 4)
        qn = self._compute_qn(N, b, offset, pulse_cap, stereo)
        if stereo and band >= ctx["intensity"]:
            qn = 1
        tell = rc.tell_frac()
        itheta = 0
        inv = 0
        if qn != 1:
            if stereo and N > 2:
                # step pdf: probability p0 below the midpoint, 1 above
                p0 = 3
                x0 = qn >> 1
                ft = p0 * (x0 + 1) + x0
                fs = rc.decode(ft)
                if fs < (x0 + 1) * p0:
                    x = fs // p0
                else:
                    x = x0 + 1 + (fs - (x0 + 1) * p0)
                rc.update(
                    p0 * x if x <= x0 else (x - 1 - x0) + (x0 + 1) * p0,
                    p0 * (x + 1) if x <= x0 else (x - x0) + (x0 + 1) * p0,
                    ft,
                )
                itheta = x
            elif B0 > 1 or stereo:
                itheta = rc.dec_uint(qn + 1)
            else:
                itheta = rc.dec_uint_tri(qn)
            itheta = (itheta * 16384) // qn
        elif stereo:
            inv = (
                rc.dec_bit_logp(2)
                if b > 2 << BITRES
                and ctx["remaining_bits"] > 2 << BITRES
                else 0
            )
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

    def _quant_band_n1(self, ctx, X, Y, lowband_out) -> int:
        """One-sample band: decode a sign per channel."""
        rc: RangeDecoder = ctx["rc"]
        x = X
        for _ in range(2 if Y is not None else 1):
            sign = 0
            if ctx["remaining_bits"] >= 1 << BITRES:
                sign = rc.rawbits(1)
                ctx["remaining_bits"] -= 1 << BITRES
            x[0] = -1.0 if sign else 1.0
            x = Y
        if lowband_out is not None:
            lowband_out[0] = X[0]
        return 1

    def _stereo_merge(self, X, Y, mid: float, N: int) -> None:
        """Rebuild L/R from normalized mid X and side Y in place."""
        xp = mid * float(np.dot(X[:N], Y[:N]))
        side = float(np.dot(Y[:N], Y[:N]))
        El = mid * mid + side - 2.0 * xp
        Er = mid * mid + side + 2.0 * xp
        if Er < 6e-4 or El < 6e-4:
            Y[:N] = X[:N]
            return
        lgain = 1.0 / math.sqrt(El)
        rgain = 1.0 / math.sqrt(Er)
        l = mid * X[:N]
        r = Y[:N].copy()
        X[:N] = lgain * (l - r)
        Y[:N] = rgain * (l + r)

    def _quant_band_stereo(self, ctx, X: np.ndarray, Y: np.ndarray,
                           N: int, b: int, B: int, lowband, LM: int,
                           lowband_out, lowband_scratch,
                           fill: int) -> int:
        """Stereo band decode: theta split into mid/side (or two-phase
        for N==2, intensity above ctx['intensity']), then merge."""
        if N == 1:
            return self._quant_band_n1(ctx, X, Y, lowband_out)
        rc: RangeDecoder = ctx["rc"]
        orig_fill = fill
        itheta, delta, fill, qalloc, inv = self._compute_theta(
            ctx, N, b, B, B, LM, fill, stereo=True
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
            sign = rc.rawbits(1) if sbits else 0
            sign = 1 - 2 * sign
            # orig_fill so the side can fold even when itheta cleared
            # the fill's low bits
            cm = self._quant_band(ctx, x2, N, mbits, B, lowband, LM,
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
                # mid keeps unit gain: the normalized mid is the fold
                # source for later bands
                cm = self._quant_band(ctx, X, N, mbits, B, lowband, LM,
                                      lowband_out, 1.0, lowband_scratch,
                                      fill)
                rebalance = mbits - (rebalance - ctx["remaining_bits"])
                if rebalance > 3 << BITRES and itheta != 0:
                    sbits += rebalance - (3 << BITRES)
                cm |= self._quant_band(ctx, Y, N, sbits, B, None, LM,
                                       None, side, None, fill >> B)
            else:
                cm = self._quant_band(ctx, Y, N, sbits, B, None, LM,
                                      None, side, None, fill >> B)
                rebalance = sbits - (rebalance - ctx["remaining_bits"])
                if rebalance > 3 << BITRES and itheta != 16384:
                    mbits += rebalance - (3 << BITRES)
                cm |= self._quant_band(ctx, X, N, mbits, B, lowband, LM,
                                       lowband_out, 1.0,
                                       lowband_scratch, fill)
            self._stereo_merge(X, Y, mid, N)
        if inv:
            Y[:N] = -Y[:N]
        return cm

    def _quant_band(self, ctx, X: np.ndarray, N: int, b: int, B: int,
                    lowband, LM: int, lowband_out, gain: float,
                    lowband_scratch, fill: int) -> int:
        N0 = N
        N_B = N // B
        B0 = B
        time_divide = 0
        recombine = 0
        longBlocks = B0 == 1
        if N == 1:
            return self._quant_band_n1(ctx, X, None, lowband_out)
        tf_change = ctx["tf_change"]
        if tf_change > 0:
            recombine = tf_change
        if (
            lowband_scratch is not None and lowband is not None
            and (recombine or ((N_B & 1) == 0 and tf_change < 0) or B0 > 1)
        ):
            lowband_scratch[:N] = lowband[:N]
            lowband = lowband_scratch
        # decode side: only the fold source is transformed on the way
        # in; X is decoded in the transformed domain and converted back
        # by the undo passes below (the encoder transforms X here)
        for k in range(recombine):
            if lowband is not None:
                _haar1(lowband, N >> k, 1 << k)
            fill = (
                int(self.bit_interleave[fill & 0xF])
                | int(self.bit_interleave[fill >> 4]) << 2
            )
        B >>= recombine
        N_B <<= recombine
        while (N_B & 1) == 0 and tf_change < 0:
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
            if lowband is not None:
                _deinterleave_hadamard(lowband, N_B >> recombine,
                                       B0 << recombine, longBlocks)
        ctx["B0"] = B0
        cm = self._quant_partition(ctx, X, N, b, B, lowband, LM, gain, fill)
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

    def _quant_all_bands(self, rc: RangeDecoder, start: int, end: int,
                         X_: np.ndarray, Y_, pulses, shortBlocks: bool,
                         spread: int, tf_res, total_bits: int, balance: int,
                         LM: int, codedBands: int, intensity: int = 0,
                         dual_stereo: int = 0):
        """Band loop: mono when Y_ is None, else coupled stereo with
        dual-stereo and intensity routing. Returns collapse masks
        shaped [C, NB_BANDS]."""
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
        }
        for i in range(start, end):
            last = i == end - 1
            effective_lowband = -1  # per band: no fold source by default
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
                spread != SPREAD_AGGRESSIVE or B > 1 or tf_change < 0
            ):
                effective_lowband = int(max(
                    0, M * eBands[lowband_offset] - norm_offset - N
                ))
                # exact do/while semantics of the fold range scan
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
                # switch off dual stereo to do intensity: fold source
                # becomes the average of the two decoded channels
                dual_stereo = 0
                upto = M * eBands[i] - norm_offset
                norm[:upto] = 0.5 * (norm[:upto] + norm2[:upto])
            if dual_stereo:
                x_cm = self._quant_band(
                    ctx, X, N, b // 2, B, lowband, LM, lowband_out, 1.0,
                    lowband_scratch, x_cm,
                )
                y_cm = self._quant_band(
                    ctx, Y, N, b // 2, B, lowband2, LM, lowband_out2,
                    1.0, lowband_scratch, y_cm,
                )
            else:
                if C == 2:
                    x_cm = self._quant_band_stereo(
                        ctx, X, Y, N, b, B, lowband, LM, lowband_out,
                        lowband_scratch, x_cm | y_cm,
                    )
                else:
                    x_cm = self._quant_band(
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

    # -- synthesis -----------------------------------------------------------
    def _imdct_block(self, freq: np.ndarray, NB: int) -> np.ndarray:
        """One low-overlap inverse MDCT block: NB spectral bins ->
        NB + OVERLAP windowed time samples (hop NB)."""
        mat = _imdct_matrix(NB)
        return freq @ mat

    def decode_frame(self, rc: RangeDecoder, frame_size: int,
                     start: int, end: int,
                     coded_channels: int = 0,
                     parse_only: bool = False) -> np.ndarray:
        """Decode one CELT frame. Returns [C, frame_size] float PCM
        at 48 kHz (C = coded channels; the caller duplicates when the
        output is stereo but the packet is mono)."""
        C = coded_channels or self.channels
        LM = {120: 0, 240: 1, 480: 2, 960: 3}[frame_size]
        N = frame_size
        M = 1 << LM
        eBands = self.eBands
        total = rc.total_bits

        tell = rc.tell()
        # the silence flag exists only when CELT owns the stream from
        # bit 1 (celt-only frames); in hybrid the coder enters midway
        if tell >= total:
            silence = True
        elif tell == 1:
            silence = bool(rc.dec_bit_logp(15))
        else:
            silence = False
        if silence:
            # consume everything; output decays to zero through the OLA
            self.oldE[:, :] = -28.0
            if parse_only:
                # zero spectrum, postfilter params held (the synthesis
                # would pass the current params as "new"), state
                # rotated exactly as _synthesize would
                self.last_parse = {
                    "freq": np.zeros((C, N)),
                    "shortBlocks": False,
                    "LM": LM,
                    "pf_period": self.pf_period,
                    "pf_gain": self.pf_gain,
                    "pf_tapset": self.pf_tapset,
                    "pf_state": (self.pf_period_old, self.pf_period,
                                 self.pf_gain_old, self.pf_gain,
                                 self.pf_tapset_old, self.pf_tapset),
                }
                self.pf_period_old = self.pf_period
                self.pf_gain_old = self.pf_gain
                self.pf_tapset_old = self.pf_tapset
                self._post_frame_energy(start, end, False)
                return None
            out = self._synthesize(np.zeros((C, N)), N, LM, False,
                                   self.pf_period, self.pf_gain,
                                   self.pf_tapset)
            self._post_frame_energy(start, end, False)
            return out

        pf_period = 15
        pf_gain = 0.0
        pf_tapset = 0
        if start == 0 and rc.tell() + 16 <= total:
            if rc.dec_bit_logp(1):
                octave = rc.dec_uint(6)
                pf_period = (16 << octave) + rc.rawbits(4 + octave) - 1
                qg = rc.rawbits(3)
                pf_gain = 0.09375 * (qg + 1)
                if rc.tell() + 2 <= total:
                    pf_tapset = rc.dec_cdf(self.tapset_icdf)

        isTransient = False
        if LM > 0 and rc.tell() + 3 <= total:
            isTransient = bool(rc.dec_bit_logp(3))
        shortBlocks = isTransient
        intra = False
        if rc.tell() + 3 <= total:
            intra = bool(rc.dec_bit_logp(3))

        self._coarse_energy(rc, start, end, intra, LM, C)

        # tf_res (libopus tf_decode: the tf_select bit is RESERVED
        # from the per-band budget up front, so the last band's flag
        # and the select bit never compete for the same bit)
        tf_res = np.zeros(NB_BANDS, dtype=np.int64)
        curr = 0
        tf_changed = 0
        logp = 2 if isTransient else 4
        budget = total
        tell = rc.tell()
        tf_select_rsv = 1 if (LM > 0 and tell + logp + 1 <= budget) else 0
        budget -= tf_select_rsv
        for i in range(start, end):
            if tell + logp <= budget:
                curr ^= rc.dec_bit_logp(logp)
                tell = rc.tell()
                tf_changed |= curr
            tf_res[i] = curr
            logp = 4 if isTransient else 5
        tf_select = 0
        it = 1 if isTransient else 0
        if (tf_select_rsv
                and self.tf_select_tab[LM][it][0][tf_changed]
                != self.tf_select_tab[LM][it][1][tf_changed]):
            tf_select = rc.dec_bit_logp(1)
        for i in range(start, end):
            tf_res[i] = self.tf_select_tab[LM][it][tf_select][tf_res[i]]

        spread = SPREAD_NORMAL
        if rc.tell() + 4 <= total:
            spread = rc.dec_cdf(self.spread_icdf)

        # caps
        cap = np.zeros(NB_BANDS, dtype=np.int64)
        for i in range(NB_BANDS):
            cap[i] = (
                (int(self.static_caps[LM][C - 1][i]) + 64)
                * C * (eBands[i + 1] - eBands[i]) << LM
            ) >> 2

        # dynalloc
        offsets = np.zeros(NB_BANDS, dtype=np.int64)
        total_bits_8 = total << BITRES
        tell_frac = rc.tell_frac()
        dynalloc_logp = 6
        total_boost = 0
        for i in range(start, end):
            width = C * (eBands[i + 1] - eBands[i]) << LM
            quanta = min(width << BITRES, max(6 << BITRES, width))
            dynalloc_loop_logp = dynalloc_logp
            boost = 0
            while (tell_frac + (dynalloc_loop_logp << BITRES)
                   < total_bits_8 - total_boost and boost < cap[i]):
                flag = rc.dec_bit_logp(dynalloc_loop_logp)
                tell_frac = rc.tell_frac()
                if not flag:
                    break
                boost += quanta
                total_boost += quanta
                dynalloc_loop_logp = 1
            if boost > 0:
                dynalloc_logp = max(2, dynalloc_logp - 1)
            offsets[i] = boost

        alloc_trim = 5
        if rc.tell_frac() + (6 << BITRES) <= total_bits_8 - total_boost:
            alloc_trim = rc.dec_cdf(self.trim_icdf)

        bits_8 = (total << BITRES) - rc.tell_frac() - 1
        anti_collapse_rsv = (
            (1 << BITRES)
            if (isTransient and LM >= 2 and bits_8 >= (LM + 2) << BITRES)
            else 0
        )
        bits_8 -= anti_collapse_rsv

        (pulses, fine_quant, fine_priority, codedBands, balance,
         intensity, dual_stereo) = self._compute_allocation(
            start, end, offsets, cap, alloc_trim, bits_8, rc, LM, C
        )

        self._fine_energy(rc, start, end, fine_quant, C)

        X = np.zeros((C, M * eBands[NB_BANDS] + 200))
        collapse_masks = self._quant_all_bands(
            rc, start, end, X[0], X[1] if C == 2 else None, pulses,
            shortBlocks, spread, tf_res,
            (total << BITRES) - anti_collapse_rsv, balance, LM, codedBands,
            intensity, dual_stereo,
        )

        anti_collapse_on = 0
        if anti_collapse_rsv > 0:
            anti_collapse_on = rc.rawbits(1)

        self._finalize_energy(rc, start, end, fine_quant, fine_priority,
                              total - rc.tell(), C)

        if anti_collapse_on:
            self._anti_collapse(X, collapse_masks, LM, start, end,
                                pulses, C)

        # denormalize
        freq = np.zeros((C, N))
        for c in range(C):
            for i in range(start, end):
                g = math.exp(
                    min(32.0, self.oldE[c, i] + self.eMeans[i])
                    * math.log(2.0)
                )
                lo_b = M * eBands[i]
                hi_b = M * eBands[i + 1]
                freq[c, lo_b:hi_b] = X[c, lo_b:hi_b] * g

        self.last_freq = freq.copy()
        self.last_X = X.copy()
        self.last_shape = (LM, shortBlocks)
        # everything the synthesis stage needs, exposed so a batched
        # device backend can run it off-host (ops/celt_batch.py)
        self.last_parse = {
            "freq": freq.copy(),
            "shortBlocks": bool(shortBlocks),
            "LM": LM,
            "pf_period": max(pf_period, COMBFILTER_MINPERIOD),
            "pf_gain": pf_gain,
            "pf_tapset": pf_tapset,
            # pre-synthesis postfilter state (the synthesis rotates it)
            "pf_state": (self.pf_period_old, self.pf_period,
                         self.pf_gain_old, self.pf_gain,
                         self.pf_tapset_old, self.pf_tapset),
        }
        if parse_only:
            # a device backend owns the synthesis state; rotate the
            # postfilter params exactly as _synthesize would
            out = None
            self.pf_period_old = self.pf_period
            self.pf_gain_old = self.pf_gain
            self.pf_tapset_old = self.pf_tapset
            self.pf_period = max(pf_period, COMBFILTER_MINPERIOD)
            self.pf_gain = pf_gain
            self.pf_tapset = pf_tapset
            if LM != 0:
                self.pf_period_old = self.pf_period
                self.pf_gain_old = self.pf_gain
                self.pf_tapset_old = self.pf_tapset
        else:
            out = self._synthesize(freq, N, LM, shortBlocks,
                                   max(pf_period, COMBFILTER_MINPERIOD),
                                   pf_gain, pf_tapset)

        self._post_frame_energy(start, end, isTransient, C)
        # the fold/noise PRNG is re-seeded from the range coder's final
        # state after every frame (not a free-running LCG)
        self.rng = int(rc.rng) & 0xFFFFFFFF
        return out

    def _post_frame_energy(self, start: int, end: int,
                           isTransient: bool, C: int = 0) -> None:
        C = C or self.channels
        if not isTransient:
            self.oldLogE2[:C] = self.oldLogE[:C]
            self.oldLogE[:C] = self.oldE[:C]
        else:
            self.oldLogE[:C] = np.minimum(self.oldLogE[:C], self.oldE[:C])
        for c in range(C):
            self.oldE[c, :start] = 0
            self.oldE[c, end:] = 0
            self.oldLogE[c, :start] = -28.0
            self.oldLogE[c, end:] = -28.0
            self.oldLogE2[c, :start] = -28.0
            self.oldLogE2[c, end:] = -28.0

    def _anti_collapse(self, X, collapse_masks, LM, start, end,
                       pulses, C=0):
        # NOTE: channel-outer, band-inner iteration (the libavcodec
        # oracle's order; libopus nests the channel loop inside the
        # band loop, which only permutes the LCG draw assignment)
        eBands = self.eBands
        seed = self.rng
        for c in range(C or self.channels):
            for i in range(start, end):
                N0 = eBands[i + 1] - eBands[i]
                depth = ((1 + int(pulses[i])) // N0) >> LM
                thresh = 0.5 * math.pow(2.0, -0.125 * depth)
                sqrt_1 = 1.0 / math.sqrt(N0 << LM)
                prev1 = self.oldLogE[c, i]
                prev2 = self.oldLogE2[c, i]
                if (C or self.channels) == 1 and self.oldLogE.shape[0] > 1:
                    prev1 = max(prev1, self.oldLogE[1, i])
                    prev2 = max(prev2, self.oldLogE2[1, i])
                Ediff = max(0.0, self.oldE[c, i] - min(prev1, prev2))
                r = 2.0 * math.pow(2.0, -Ediff)
                if LM == 3:
                    r *= 1.41421356
                r = min(thresh, r) * sqrt_1
                band = X[c, (eBands[i] << LM):(eBands[i + 1] << LM)]
                renorm = False
                mask = int(collapse_masks[c if collapse_masks.shape[0] == 2 else 0][i])
                for k in range(1 << LM):
                    if not (mask & (1 << k)):
                        for j in range(N0):
                            seed = _lcg(seed)
                            band[(j << LM) + k] = r if (seed & 0x8000) else -r
                        renorm = True
                if renorm:
                    _renormalise(band)
        self.rng = seed

    def _synthesize(self, freq: np.ndarray, N: int, LM: int,
                    shortBlocks: bool, pf_period: int, pf_gain: float,
                    pf_tapset: int) -> np.ndarray:
        """Inverse MDCT + overlap-add + comb postfilter (with the
        old->current and current->new crossfades of the oracle) +
        de-emphasis."""
        C = freq.shape[0]
        M = 1 << LM
        B = M if shortBlocks else 1
        NB = N // B
        HIST = 1200  # > max period 1024 + taps
        res = np.zeros((C, N))
        for c in range(C):
            out = np.zeros(N + OVERLAP)
            out[:OVERLAP] = self.ola[c]
            for b in range(B):
                blk = self._imdct_block(freq[c, b::B], NB)
                out[b * NB : b * NB + NB + OVERLAP] += blk
            self.ola[c] = out[N : N + OVERLAP]
            # comb postfilter: in-place over [hist | frame]
            x = np.concatenate([self.hist[c][-HIST:], out[:N]])
            base = HIST
            self._comb_inplace(
                x, base, 0, min(120, N),
                self.pf_period_old, self.pf_period,
                self.pf_gain_old, self.pf_gain,
                self.pf_tapset_old, self.pf_tapset,
            )
            if LM != 0:
                self._comb_inplace(
                    x, base, 120, N,
                    self.pf_period, pf_period,
                    self.pf_gain, pf_gain,
                    self.pf_tapset, pf_tapset,
                )
            pcm = x[base : base + N]
            self.hist[c] = np.concatenate([self.hist[c][N:], pcm]) \
                if N < self.hist.shape[1] else pcm[-self.hist.shape[1]:]
            if self.hist[c].shape[0] != self.hist.shape[1]:
                h = np.zeros(self.hist.shape[1])
                h[-len(pcm):] = pcm
                self.hist[c] = h
            # de-emphasis
            m = self.preemph_mem[c]
            o = np.empty(N)
            for j in range(N):
                m = pcm[j] + CELT_EMPH_COEFF * m
                o[j] = m
            self.preemph_mem[c] = m
            res[c] = o
        # postfilter state rotation (old <- current <- new; for LM != 0
        # the second comb already reached the new params this frame)
        self.pf_period_old = self.pf_period
        self.pf_gain_old = self.pf_gain
        self.pf_tapset_old = self.pf_tapset
        self.pf_period = pf_period
        self.pf_gain = pf_gain
        self.pf_tapset = pf_tapset
        if LM != 0:
            self.pf_period_old = self.pf_period
            self.pf_gain_old = self.pf_gain
            self.pf_tapset_old = self.pf_tapset
        return res / 32768.0

    def _comb_inplace(self, x, base, i0, i1, T0, T1, g0, g1, t0, t1):
        """y[i] = x[i] + comb taps, in place (in-frame lookback reads
        already-filtered samples, as in the oracle's in-place filter)."""
        if g0 == 0.0 and g1 == 0.0:
            return
        T0 = max(T0, COMBFILTER_MINPERIOD)
        T1 = max(T1, COMBFILTER_MINPERIOD)
        taps = self.pf_taps
        g00, g01, g02 = g0 * taps[t0][0], g0 * taps[t0][1], g0 * taps[t0][2]
        g10, g11, g12 = g1 * taps[t1][0], g1 * taps[t1][1], g1 * taps[t1][2]
        overlap = min(OVERLAP, i1 - i0)
        for i in range(overlap):
            f = self.window[i] * self.window[i]
            j = base + i0 + i
            x[j] = (
                x[j]
                + (1 - f) * (
                    g00 * x[j - T0]
                    + g01 * (x[j - T0 - 1] + x[j - T0 + 1])
                    + g02 * (x[j - T0 - 2] + x[j - T0 + 2])
                )
                + f * (
                    g10 * x[j - T1]
                    + g11 * (x[j - T1 - 1] + x[j - T1 + 1])
                    + g12 * (x[j - T1 - 2] + x[j - T1 + 2])
                )
            )
        if g1 != 0.0:
            for i in range(i0 + overlap, i1):
                j = base + i
                x[j] = (
                    x[j]
                    + g10 * x[j - T1]
                    + g11 * (x[j - T1 - 1] + x[j - T1 + 1])
                    + g12 * (x[j - T1 - 2] + x[j - T1 + 2])
                )


_IMDCT_CACHE = {}


def _imdct_matrix(NB: int) -> np.ndarray:
    """[NB, NB+OVERLAP] low-overlap IMDCT basis: bin k -> windowed time
    response at hop NB (window rises over OVERLAP, flat middle)."""
    if NB in _IMDCT_CACHE:
        return _IMDCT_CACHE[NB]
    t = tables()
    w = t["celt_window"].astype(np.float64)
    L = 2 * NB
    n = np.arange(L, dtype=np.float64)
    k = np.arange(NB, dtype=np.float64)
    # oddly-stacked IMDCT, n0 = (L/2 + 1)/... standard MDCT phase
    # unnormalized backward transform: the energy convention carries
    # the scale, and the final /32768 maps celt_sig to float PCM
    basis = np.cos(
        2.0 * np.pi / L
        * (n[None, :] + 0.5 + L / 4.0) * (k[:, None] + 0.5)
    )
    # low-overlap window: support is the middle NB+OVERLAP samples
    win = np.zeros(L)
    pad = (NB - OVERLAP) // 2
    win[pad : pad + OVERLAP] = w
    win[pad + OVERLAP : pad + NB] = 1.0
    win[pad + NB : pad + NB + OVERLAP] = w[::-1]
    mat = (basis * win[None, :])[:, pad : pad + NB + OVERLAP]
    _IMDCT_CACHE[NB] = mat
    return mat
