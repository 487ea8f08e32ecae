"""RFC 6716 §4.1 range decoder (the entropy layer shared by SILK and
CELT), plus the §4.3.2.1 Laplace decoder used for CELT coarse energy.

Implements the normative algorithm: 32-bit lag, 8-bit renormalization
bytes read from the front (carry-less, one spare bit), raw bits read
LSB-first from the END of the frame, and ec_tell/ec_tell_frac budget
accounting.  Parity reference: soundkit-opus/src/lib.rs delegates all
of this to libopus; here it is owned code.
"""
from __future__ import annotations

from math import isqrt as math_isqrt


class OpusError(ValueError):
    pass


_CODE_BITS = 32
_SYM_BITS = 8
_SYM_MAX = 0xFF
_CODE_TOP = 1 << (_CODE_BITS - 1)
_CODE_BOT = _CODE_TOP >> _SYM_BITS          # 1 << 23
_CODE_EXTRA = (_CODE_BITS - 2) % _SYM_BITS + 1  # 7


def ilog(v) -> int:
    return int(v).bit_length()


class RangeDecoder:
    def __init__(self, data: bytes):
        self.buf = data
        self.storage = len(data)
        self.offs = 0          # front read position
        self.end_offs = 0      # bytes consumed from the end
        self.end_window = 0
        self.nend_bits = 0
        self.nbits_total = _CODE_BITS + 1 - (
            (_CODE_BITS - _CODE_EXTRA) // _SYM_BITS
        ) * _SYM_BITS
        self.rng = 1 << _CODE_EXTRA
        self.rem = self._read_byte()
        self.val = self.rng - 1 - (self.rem >> (_SYM_BITS - _CODE_EXTRA))
        self.error = False
        self._normalize()

    def set_state(self, state) -> None:
        """Restore mid-stream coder state exported by the native SILK
        stage (silk_parse.cpp skt_silk_decode info[4..12]) so a hybrid
        frame's CELT layer continues from the SILK-consumed position."""
        (self.offs, self.rem, self.end_offs, self.end_window,
         self.nend_bits, self.nbits_total, self.rng, self.val,
         err) = state
        self.error = bool(err)

    # -- byte feeds -----------------------------------------------------
    def _read_byte(self) -> int:
        if self.offs < self.storage:
            b = self.buf[self.offs]
            self.offs += 1
            return b
        return 0

    def _read_byte_from_end(self) -> int:
        if self.end_offs < self.storage:
            self.end_offs += 1
            return self.buf[self.storage - self.end_offs]
        return 0

    def _normalize(self) -> None:
        while self.rng <= _CODE_BOT:
            self.nbits_total += _SYM_BITS
            self.rng = (self.rng << _SYM_BITS) & 0xFFFFFFFF
            sym = self.rem
            self.rem = self._read_byte()
            sym = ((sym << _SYM_BITS) | self.rem) >> (_SYM_BITS - _CODE_EXTRA)
            self.val = (
                (self.val << _SYM_BITS) + (_SYM_MAX & ~sym)
            ) & (_CODE_TOP - 1)

    # -- core decode ----------------------------------------------------
    def decode(self, ft: int) -> int:
        """Start decoding a symbol with total frequency ``ft``; returns
        the cumulative frequency fs in [0, ft)."""
        self.ext = self.rng // ft
        s = self.val // self.ext
        return ft - min(s + 1, ft)

    def decode_bin(self, ftb: int) -> int:
        """decode() with ft = 1 << ftb (power-of-two total)."""
        self.ext = self.rng >> ftb
        s = self.val // self.ext
        return (1 << ftb) - min(s + 1, 1 << ftb)

    def update(self, fl: int, fh: int, ft: int) -> None:
        s = self.ext * (ft - fh)
        self.val -= s
        self.rng = self.ext * (fh - fl) if fl > 0 else self.rng - s
        self._normalize()

    # -- convenience ----------------------------------------------------
    def dec_bit_logp(self, logp: int) -> int:
        r = self.rng
        d = self.val
        s = r >> logp
        ret = 1 if d < s else 0
        if not ret:
            self.val = d - s
        self.rng = s if ret else r - s
        self._normalize()
        return ret

    def dec_icdf(self, icdf, ftb: int) -> int:
        """libopus-style inverse-CDF table (icdf[k] = ft - cdf[k+1],
        terminated by 0), power-of-two total 1 << ftb."""
        s = self.rng
        d = self.val
        r = s >> ftb
        ret = -1
        while True:
            ret += 1
            t = s
            s = r * int(icdf[ret])
            if d >= s:
                break
        self.val = d - s
        self.rng = t - s
        self._normalize()
        return ret

    def dec_cdf(self, cdf) -> int:
        """FFmpeg-layout model table: cdf[0] = ft, then the cumulative
        frequencies cdf[1..] ending in ft (the extracted opustab
        format)."""
        total = int(cdf[0])
        scale = self.rng // total
        self.ext = scale
        sym = total - min(self.val // scale + 1, total)
        k = 1
        while int(cdf[k]) <= sym:
            k += 1
        high = int(cdf[k])
        low = int(cdf[k - 1]) if k > 1 else 0
        self.update(low, high, total)
        return k - 1

    def dec_uint(self, ft: int) -> int:
        """Uniform in [0, ft) (RFC 4.1.5): top bits entropy-coded, low
        bits raw from the end."""
        if ft <= 1:
            return 0
        ftb = ilog(ft - 1)
        if ftb > 8:
            ftb -= 8
            ft1 = ((ft - 1) >> ftb) + 1
            fs = self.decode(ft1)
            self.update(fs, fs + 1, ft1)
            t = (fs << ftb) | self.rawbits(ftb)
            if t <= ft - 1:
                return t
            self.error = True
            return ft - 1
        fs = self.decode(ft)
        self.update(fs, fs + 1, ft)
        return fs

    def dec_uint_tri(self, qn: int) -> int:
        """Triangular pdf over [0, qn] (CELT mono theta)."""
        ft = ((qn >> 1) + 1) * ((qn >> 1) + 1)
        fm = self.decode(ft)
        if fm < ((qn >> 1) * ((qn >> 1) + 1) >> 1):
            itheta = (int(math_isqrt(8 * fm + 1)) - 1) >> 1
            fs = itheta + 1
            fl = itheta * (itheta + 1) >> 1
        else:
            itheta = (2 * (qn + 1) - int(math_isqrt(8 * (ft - fm - 1) + 1))) >> 1
            fs = qn + 1 - itheta
            fl = ft - ((qn + 1 - itheta) * (qn + 2 - itheta) >> 1)
        self.update(fl, fl + fs, ft)
        return itheta

    def dec_uint_step(self, k0: int) -> int:
        """Step pdf (CELT stereo theta, N > 2): symbols 0..2*k0 with
        the first k0+1 twice as likely."""
        k1 = (k0 + 1) * 3
        total = (k0 + 1) * 3 + k0
        fm = self.decode(total)
        if fm < k1:
            k = fm // 3
            self.update(3 * k, 3 * k + 3, total)
        else:
            k = k0 + 1 + (fm - k1)
            self.update(3 * (k0 + 1) + (k - k0 - 1),
                        3 * (k0 + 1) + (k - k0), total)
        return k

    def rawbits(self, bits: int) -> int:
        while self.nend_bits < bits:
            self.end_window |= self._read_byte_from_end() << self.nend_bits
            self.nend_bits += 8
        ret = self.end_window & ((1 << bits) - 1)
        self.end_window >>= bits
        self.nend_bits -= bits
        self.nbits_total += bits
        return ret

    def tell(self) -> int:
        return self.nbits_total - ilog(self.rng)

    def tell_frac(self) -> int:
        """Bit usage to 1/8th-bit precision (RFC 4.1.6.1)."""
        correction = (35733, 38967, 42495, 46340,
                      50535, 55109, 60097, 65535)
        nbits = self.nbits_total << 3
        l = ilog(self.rng)
        r = self.rng >> (l - 16)
        b = (r >> 12) - 8
        b += 1 if r > correction[b] else 0
        l = (l << 3) + b
        return nbits - l

    @property
    def total_bits(self) -> int:
        return self.storage * 8


# -- Laplace decoder for CELT coarse energy (RFC 4.3.2.1) ---------------
_LAPLACE_MINP = 1
_LAPLACE_NMIN = 16


def _laplace_get_freq1(fs0: int, decay: int) -> int:
    ft = 32768 - _LAPLACE_MINP * (2 * _LAPLACE_NMIN) - fs0
    return (ft * (16384 - decay)) >> 15


def laplace_decode(rc: RangeDecoder, fs: int, decay: int) -> int:
    val = 0
    fl = 0
    fm = rc.decode_bin(15)
    if fm >= fs:
        val += 1
        fl = fs
        fs = _laplace_get_freq1(fs, decay) + _LAPLACE_MINP
        while fs > _LAPLACE_MINP and fm >= fl + 2 * fs:
            fs *= 2
            fl += fs
            fs = ((fs - 2 * _LAPLACE_MINP) * decay) >> 15
            fs += _LAPLACE_MINP
            val += 1
        if fs <= _LAPLACE_MINP:
            di = (fm - fl) >> 1
            val += di
            fl += 2 * di * _LAPLACE_MINP
        if fm < fl + fs:
            val = -val
        else:
            fl += fs
    rc.update(fl, min(fl + fs, 32768), 32768)
    return val
