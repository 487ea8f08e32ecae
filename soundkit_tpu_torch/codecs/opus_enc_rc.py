"""RFC 6716 §4.1 range ENCODER — the exact inverse of the owned
range decoder (opus_rc.py), plus the Laplace / triangular / step /
uniform interval encoders used by the CELT layer.

Every encoder here is derived from the corresponding decoder's
interval arithmetic, so a (value -> bytes -> value) round trip through
opus_rc.RangeDecoder is exact by construction; the property tests in
tests/test_opus_encoder.py drive randomized symbol programs through
both directions.  Because the owned decoder is the RFC-conformant
function bytes -> symbols (validated against real libopus streams),
any byte stream it maps to the intended symbols is a valid encoding
for every conformant decoder.

Parity reference: the reference encodes via pure-Rust libopus-rs
(soundkit-opus/src/lib.rs, Cargo.toml:11-14); here the entropy layer
is owned code.
"""
from __future__ import annotations

from soundkit_tpu_torch.codecs.opus_rc import ilog

_CODE_BITS = 32
_SYM_BITS = 8
_SYM_MAX = 0xFF
_CODE_TOP = 1 << (_CODE_BITS - 1)
_CODE_BOT = _CODE_TOP >> _SYM_BITS
_CODE_SHIFT = _CODE_BITS - _SYM_BITS - 1  # 23


class RangeEncoderError(ValueError):
    pass


class RangeEncoder:
    """Carry-propagating range encoder writing entropy bytes from the
    front of a fixed-size buffer and raw bits LSB-first from the end
    (the layout opus_rc.RangeDecoder reads)."""

    def __init__(self, size: int):
        self.size = size
        self.buf = bytearray(size)
        self.offs = 0          # front bytes emitted
        self.end_offs = 0      # end bytes emitted
        self.val = 0
        self.rng = _CODE_TOP
        self.rem = -1          # pending carry byte (-1 = none yet)
        self.ext = 0           # run of 0xFF bytes awaiting carry
        self.end_window = 0
        self.nend_bits = 0
        self.nbits_total = _CODE_BITS + 1
        self.error = False

    # -- byte sinks ------------------------------------------------------
    def _write_byte(self, b: int) -> None:
        if self.offs + self.end_offs >= self.size:
            self.error = True
            return
        self.buf[self.offs] = b & 0xFF
        self.offs += 1

    def _write_byte_at_end(self, b: int) -> None:
        if self.offs + self.end_offs >= self.size:
            self.error = True
            return
        self.end_offs += 1
        self.buf[self.size - self.end_offs] = b & 0xFF

    def _carry_out(self, c: int) -> None:
        if c != _SYM_MAX:
            carry = c >> _SYM_BITS
            if self.rem >= 0:
                self._write_byte(self.rem + carry)
            if self.ext > 0:
                sym = (_SYM_MAX + carry) & _SYM_MAX
                for _ in range(self.ext):
                    self._write_byte(sym)
                self.ext = 0
            self.rem = c & _SYM_MAX
        else:
            self.ext += 1

    def _normalize(self) -> None:
        while self.rng <= _CODE_BOT:
            self._carry_out(self.val >> _CODE_SHIFT)
            self.val = (self.val << _SYM_BITS) & (_CODE_TOP - 1)
            self.rng = (self.rng << _SYM_BITS) & 0xFFFFFFFF
            self.nbits_total += _SYM_BITS

    # -- core encode -------------------------------------------------------
    def encode(self, fl: int, fh: int, ft: int) -> None:
        r = self.rng // ft
        if fl > 0:
            self.val += self.rng - r * (ft - fl)
            self.rng = r * (fh - fl)
        else:
            self.rng -= r * (ft - fh)
        self._normalize()

    def encode_bin(self, fl: int, fh: int, ftb: int) -> None:
        r = self.rng >> ftb
        if fl > 0:
            self.val += self.rng - r * ((1 << ftb) - fl)
            self.rng = r * (fh - fl)
        else:
            self.rng -= r * ((1 << ftb) - fh)
        self._normalize()

    # -- convenience ---------------------------------------------------------
    def enc_bit_logp(self, bit: int, logp: int) -> None:
        r = self.rng
        s = r >> logp
        r -= s
        if bit:
            self.val += r
            self.rng = s
        else:
            self.rng = r
        self._normalize()

    def enc_cdf(self, sym: int, cdf) -> None:
        """FFmpeg-layout model table (cdf[0] = ft, then cumulative
        frequencies) — the format opus_rc.dec_cdf reads."""
        total = int(cdf[0])
        fl = int(cdf[sym]) if sym >= 1 else 0
        fh = int(cdf[sym + 1])
        self.encode(fl, fh, total)

    def enc_uint(self, t: int, ft: int) -> None:
        """Uniform in [0, ft) (RFC 4.1.5)."""
        if ft <= 1:
            return
        ftb = ilog(ft - 1)
        if ftb > 8:
            ftb -= 8
            ft1 = ((ft - 1) >> ftb) + 1
            fs = t >> ftb
            self.encode(fs, fs + 1, ft1)
            self.rawbits(t & ((1 << ftb) - 1), ftb)
        else:
            self.encode(t, t + 1, ft)

    def enc_uint_tri(self, itheta: int, qn: int) -> None:
        """Triangular pdf over [0, qn] (CELT mono theta);
        inverse of dec_uint_tri."""
        half = qn >> 1
        ft = (half + 1) * (half + 1)
        if itheta <= half:
            fs = itheta + 1
            fl = itheta * (itheta + 1) >> 1
        else:
            fs = qn + 1 - itheta
            fl = ft - ((qn + 1 - itheta) * (qn + 2 - itheta) >> 1)
        self.encode(fl, fl + fs, ft)

    def enc_uint_step(self, k: int, k0: int) -> None:
        """Step pdf (CELT stereo theta, N > 2); inverse of
        dec_uint_step / the stereo branch of _compute_theta."""
        p0 = 3
        total = (k0 + 1) * p0 + k0
        if k <= k0:
            fl, fh = p0 * k, p0 * (k + 1)
        else:
            fl = (k - 1 - k0) + (k0 + 1) * p0
            fh = (k - k0) + (k0 + 1) * p0
        self.encode(fl, fh, total)

    def rawbits(self, value: int, bits: int) -> None:
        """Raw bits, LSB-first from the end of the buffer."""
        if self.nend_bits + bits > 32:
            while self.nend_bits >= _SYM_BITS:
                self._write_byte_at_end(self.end_window & _SYM_MAX)
                self.end_window >>= _SYM_BITS
                self.nend_bits -= _SYM_BITS
        self.end_window |= (value & ((1 << bits) - 1)) << self.nend_bits
        self.nend_bits += bits
        self.nbits_total += bits

    # -- budget ---------------------------------------------------------------
    def tell(self) -> int:
        return self.nbits_total - ilog(self.rng)

    def tell_frac(self) -> int:
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
        return self.size * 8

    # -- finalize ---------------------------------------------------------------
    def finalize(self) -> bytes:
        """Flush the final state; returns the complete packet bytes."""
        # choose the shortest value in [val, val+rng) with as many
        # trailing zero bits as possible
        l = _CODE_BITS - ilog(self.rng)
        msk = (_CODE_TOP - 1) >> l
        end = (self.val + msk) & ~msk
        if (end | msk) >= self.val + self.rng:
            l += 1
            msk >>= 1
            end = (self.val + msk) & ~msk
        while l > 0:
            self._carry_out(end >> _CODE_SHIFT)
            end = (end << _SYM_BITS) & (_CODE_TOP - 1)
            l -= _SYM_BITS
        if self.rem >= 0 or self.ext > 0:
            self._carry_out(0)
        # flush the raw-bit window
        window = self.end_window
        used = self.nend_bits
        while used >= _SYM_BITS:
            self._write_byte_at_end(window & _SYM_MAX)
            window >>= _SYM_BITS
            used -= _SYM_BITS
        if not self.error and used > 0:
            # the remaining <8 raw bits share the boundary byte: OR
            # into the byte just before the end region (a zero middle
            # byte, or — when the buffer is exactly full — the last
            # range byte, whose -l low bits are unused)
            if self.end_offs >= self.size:
                self.error = True
            else:
                if self.offs + self.end_offs >= self.size and -l < used:
                    window &= (1 << -l) - 1
                    self.error = True
                self.buf[self.size - self.end_offs - 1] |= window & 0xFF
        if self.error:
            raise RangeEncoderError("range encoder buffer overflow")
        return bytes(self.buf)


# -- Laplace encoder for CELT coarse energy (inverse of laplace_decode) --
_LAPLACE_MINP = 1
_LAPLACE_NMIN = 16


def _laplace_get_freq1(fs0: int, decay: int) -> int:
    ft = 32768 - _LAPLACE_MINP * (2 * _LAPLACE_NMIN) - fs0
    return (ft * (16384 - decay)) >> 15


def laplace_interval(fs0: int, decay: int, val: int):
    """(fl, fs, coded_val) for encoding ``val``; coded_val is ``val``
    clamped to the largest magnitude whose interval fits in the 32768
    total.  Mirrors laplace_decode's walk exactly."""
    if val == 0:
        return 0, fs0, 0
    neg = val < 0
    m = -val if neg else val
    fl = fs0
    fs = _laplace_get_freq1(fs0, decay) + _LAPLACE_MINP
    mag = 1
    while fs > _LAPLACE_MINP and mag < m:
        nfs = fs * 2
        nfl = fl + nfs
        nfs = ((nfs - 2 * _LAPLACE_MINP) * decay) >> 15
        nfs += _LAPLACE_MINP
        # the next magnitude must leave room for both sign intervals
        if nfl + 2 * nfs > 32768:
            break
        fs, fl = nfs, nfl
        mag += 1
    if fs <= _LAPLACE_MINP and mag < m:
        # uniform tail: each further magnitude is 2*MINP wide
        di = m - mag
        max_di = (32768 - fl - 2 * fs) // (2 * _LAPLACE_MINP)
        if di > max_di:
            di = max_di
        fl += 2 * di * _LAPLACE_MINP
        mag += di
    if not neg:
        fl += fs
    return fl, fs, (-mag if neg else mag)


def laplace_encode(rc: RangeEncoder, val: int, fs0: int, decay: int) -> int:
    """Encode ``val``; returns the value actually coded (clamped when
    the tail saturates), which the caller must use for state updates."""
    fl, fs, coded = laplace_interval(fs0, decay, val)
    rc.encode_bin(fl, min(fl + fs, 32768), 15)
    return coded
