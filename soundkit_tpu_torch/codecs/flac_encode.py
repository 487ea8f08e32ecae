"""From-scratch FLAC encoder: fixed + LPC subframes, Rice coding.

Role-equivalent of the reference's pure frame encoder
(soundkit-flac/src/frame_codec.rs:42-278 ``FlacFrameConfig`` /
``FlacFrameEncoder`` over the flacenc crate): independently decodable
frames for latency-sensitive transports, with the same three effort
profiles (realtime = fixed predictors only, balanced = fixed + one
mid-order LPC, maximum = LPC order search), plus a full-stream writer
(fLaC marker + STREAMINFO + MD5) the frame wrapper lacks.

Everything is owned: predictor search, Levinson-Durbin LPC,
coefficient quantization, Rice parameter / partition-order search,
frame CRC-8/CRC-16, UTF-8 frame numbers.  Rice coding is
numpy-vectorized (per-partition bit arrays assembled with cumsum
offsets) rather than per-sample Python loops.

Round-trips bit-exactly through the framework's own decoder
(native/src/flac.cpp) and the libavcodec oracle — see
tests/test_flac_encode.py.
"""
from __future__ import annotations

import hashlib
import struct
from typing import List, Optional, Tuple

import numpy as np

FIXED_COEFS = [
    np.array([], np.int64),
    np.array([1], np.int64),
    np.array([2, -1], np.int64),
    np.array([3, -3, 1], np.int64),
    np.array([4, -6, 4, -1], np.int64),
]

_BLOCK_SIZE_CODES = {
    192: 1, 576: 2, 1152: 3, 2304: 4, 4608: 5,
    256: 8, 512: 9, 1024: 10, 2048: 11, 4096: 12,
    8192: 13, 16384: 14, 32768: 15,
}
_RATE_CODES = {
    88200: 1, 176400: 2, 192000: 3, 8000: 4, 16000: 5, 22050: 6,
    24000: 7, 32000: 8, 44100: 9, 48000: 10, 96000: 11,
}
_BITS_CODES = {8: 1, 12: 2, 16: 4, 20: 5, 24: 6}
_KIND_CODE = {"constant": 0, "verbatim": 1, "fixed": 2, "lpc": 3}


def _native_lib():
    """The port's native bit-packer (``native.flac_pack_library``, built
    from ``native_src/src/flac_pack.cpp`` at first use); a failed build
    raises ``_build.BuildError``."""
    from soundkit_tpu_torch.native import flac_pack_library

    return flac_pack_library()


class BitWriter:
    """MSB-first bit packer (FLAC bit order) over numpy bit chunks."""

    def __init__(self) -> None:
        self._chunks: List[np.ndarray] = []
        self._nbits = 0

    def write(self, value: int, n: int) -> None:
        if n == 0:
            return
        value &= (1 << n) - 1
        bits = np.zeros(n, np.uint8)
        for i in range(n):
            bits[i] = (value >> (n - 1 - i)) & 1
        self._chunks.append(bits)
        self._nbits += n

    def write_bits_array(self, bits: np.ndarray) -> None:
        self._chunks.append(bits.astype(np.uint8, copy=False))
        self._nbits += len(bits)

    def align(self) -> None:
        pad = (-self._nbits) % 8
        if pad:
            self.write(0, pad)

    def bytes(self) -> bytes:
        if not self._chunks:
            return b""
        allbits = np.concatenate(self._chunks)
        pad = (-len(allbits)) % 8
        if pad:
            allbits = np.concatenate([allbits, np.zeros(pad, np.uint8)])
        return np.packbits(allbits).tobytes()


def _crc8(data: bytes) -> int:
    crc = 0
    for b in data:
        crc ^= b
        for _ in range(8):
            crc = ((crc << 1) ^ 0x07) & 0xFF if crc & 0x80 else (crc << 1) & 0xFF
    return crc


def _crc16(data: bytes) -> int:
    crc = 0
    for b in data:
        crc ^= b << 8
        for _ in range(8):
            crc = ((crc << 1) ^ 0x8005) & 0xFFFF if crc & 0x8000 else (crc << 1) & 0xFFFF
    return crc


def _utf8_frame_number(n: int) -> bytes:
    """FLAC's extended UTF-8 coding of the frame/sample number."""
    if n < 0x80:
        return bytes([n])
    out = []
    bits = n.bit_length()
    nbytes = 2
    while bits > 6 * (nbytes - 1) + (7 - nbytes):
        nbytes += 1
    lead = (0xFF << (8 - nbytes)) & 0xFF
    shift = 6 * (nbytes - 1)
    out.append(lead | (n >> shift))
    for i in range(nbytes - 1):
        shift -= 6
        out.append(0x80 | ((n >> shift) & 0x3F))
    return bytes(out)


def _rice_bits(w: BitWriter, res: np.ndarray, k: int) -> None:
    """Append the Rice codes of ``res`` with parameter ``k`` (folded
    zigzag, unary quotient + k-bit remainder), fully vectorized."""
    r = res.astype(np.int64)
    u = ((r << 1) ^ (r >> 63)).astype(np.uint64)
    q = (u >> np.uint64(k)).astype(np.int64)
    lengths = q + 1 + k
    total = int(lengths.sum())
    off = np.concatenate([[0], np.cumsum(lengths)[:-1]])
    bits = np.zeros(total, np.uint8)
    bits[off + q] = 1  # unary terminator after q zeros
    for b in range(k):
        bits[off + q + 1 + b] = ((u >> np.uint64(k - 1 - b)) & np.uint64(1)).astype(np.uint8)
    w.write_bits_array(bits)


def _rice_cost(res: np.ndarray, k: int) -> int:
    r = res.astype(np.int64)
    u = ((r << 1) ^ (r >> 63)).astype(np.uint64)
    return int((u >> np.uint64(k)).sum()) + len(res) * (1 + k)


def _best_rice_k(res: np.ndarray, max_k: int = 30) -> Tuple[int, int]:
    """(k, bits).  Start from the mean-based estimate and refine.

    The candidate window is clamped so it stays non-empty when the
    folded mean exceeds 2^32 (k0 > max_k + 2): k = max_k must be
    evaluated there, or k = 0 wins by default and the unary coding
    explodes (native/src/flac_pack.cpp mirrors this exactly)."""
    r = res.astype(np.int64)
    u = ((r << 1) ^ (r >> 63)).astype(np.uint64)
    mean = float(u.mean()) if len(u) else 0.0
    k0 = max(int(mean).bit_length() - 1, 0) if mean >= 1 else 0
    best = (0, _rice_cost(res, 0))
    for k in range(min(max(k0 - 2, 0), max_k), min(k0 + 3, max_k) + 1):
        c = _rice_cost(res, k)
        if c < best[1]:
            best = (k, c)
    return best


def _residual_cost(res: np.ndarray) -> int:
    return _best_rice_k(res)[1]


class _SubframePlan:
    __slots__ = ("kind", "order", "res", "qlp", "shift", "precision", "bits",
                 "warmup", "cost")

    def __init__(self, kind, order, res, bits, warmup, cost,
                 qlp=None, shift=0, precision=0):
        self.kind = kind  # "constant" | "verbatim" | "fixed" | "lpc"
        self.order = order
        self.res = res
        self.bits = bits
        self.warmup = warmup
        self.cost = cost
        self.qlp = qlp
        self.shift = shift
        self.precision = precision


def _fixed_residual(x: np.ndarray, order: int) -> np.ndarray:
    r = x.astype(np.int64)
    for _ in range(order):
        r = np.diff(r)
    return r


def _quantize_lpc(lpc: np.ndarray, precision: int = 14) -> Tuple[np.ndarray, int]:
    """Quantize float LPC coefficients to precision bits + shift
    (libFLAC-style: shift bounded to [0, 15])."""
    cmax = float(np.abs(lpc).max())
    if cmax <= 0:
        return np.zeros(len(lpc), np.int64), 0
    log2cmax = np.frexp(cmax)[1]
    shift = precision - log2cmax - 1
    shift = max(0, min(15, shift))
    q = np.clip(
        np.round(lpc * (1 << shift)),
        -(1 << (precision - 1)),
        (1 << (precision - 1)) - 1,
    ).astype(np.int64)
    return q, shift


def _lpc_order_residual(x: np.ndarray, order: int, precision: int = 14):
    """Levinson-Durbin LPC fit; returns (qlp, shift, residual) or None."""
    n = len(x)
    if n <= order * 2:
        return None
    xf = x.astype(np.float64)
    # Welch-windowed autocorrelation (simple, stable)
    w = 1.0 - (np.linspace(-1.0, 1.0, n)) ** 2
    xw = xf * w
    ac = np.array([np.dot(xw[: n - i], xw[i:]) for i in range(order + 1)])
    if ac[0] == 0:
        return None
    err = ac[0]
    a = np.zeros(order)
    for i in range(order):
        acc = ac[i + 1] - np.dot(a[:i], ac[1 : i + 1][::-1])
        k = acc / err
        a[:i] = a[:i] - k * a[:i][::-1]
        a[i] = k
        err *= 1.0 - k * k
        if err <= 0:
            return None
    qlp, shift = _quantize_lpc(a, precision)
    if not qlp.any():
        return None
    xi = x.astype(np.int64)
    # prediction: sum qlp[j] * x[i-1-j] >> shift
    pred = np.zeros(n - order, np.int64)
    for j in range(order):
        pred += qlp[j] * xi[order - 1 - j : n - 1 - j]
    res = xi[order:] - (pred >> shift)
    return qlp, shift, res


def _plan_subframe(x: np.ndarray, bits: int, profile: str) -> _SubframePlan:
    n = len(x)
    xi = x.astype(np.int64)
    if np.all(xi == xi[0]):
        return _SubframePlan("constant", 0, None, bits, xi[:1], bits + 8)
    verbatim_cost = n * bits + 8
    best: Optional[_SubframePlan] = None
    for order in range(5):
        res = _fixed_residual(xi, order)
        cost = _residual_cost(res) + order * bits + 8 + 6
        if best is None or cost < best.cost:
            best = _SubframePlan("fixed", order, res, bits, xi[:order], cost)
    lpc_orders = {"realtime": [], "balanced": [8], "maximum": [2, 4, 8, 12]}[profile]
    for order in lpc_orders:
        got = _lpc_order_residual(xi, order)
        if got is None:
            continue
        qlp, shift, res = got
        precision = 14
        cost = (_residual_cost(res) + order * bits + 8 + 6
                + 4 + 5 + order * precision)
        if cost < best.cost:
            best = _SubframePlan("lpc", order, res, bits, xi[:order], cost,
                                 qlp=qlp, shift=shift, precision=precision)
    if best.cost >= verbatim_cost:
        return _SubframePlan("verbatim", 0, None, bits, xi, verbatim_cost)
    return best


def _write_residual(w: BitWriter, res: np.ndarray, n: int, pred_order: int) -> None:
    """Residual section: Rice/Rice2 method + partition order search."""
    # choose the best partition order dividing n with the first
    # partition non-empty, capped at 6; evaluate cost per order
    best_po, best_cost, best_ks = 0, None, [_best_rice_k(res)[0]]
    for po in range(0, 7):
        parts = 1 << po
        if n % parts:
            continue
        plen = n // parts
        if plen <= pred_order or plen < 1:
            continue
        ks, cost = [], 0
        off = 0
        for p in range(parts):
            cnt = plen - pred_order if p == 0 else plen
            k, c = _best_rice_k(res[off : off + cnt])
            ks.append(k)
            cost += c
            off += cnt
        cost += parts * (5 if max(ks) > 14 else 4)
        if best_cost is None or cost < best_cost:
            best_po, best_cost, best_ks = po, cost, ks
    # method 1 (5-bit Rice2 params) when any k exceeds the 4-bit range
    # (24-bit side channels routinely need k > 14)
    method = 1 if max(best_ks) > 14 else 0
    pbits = 5 if method else 4
    w.write(method, 2)
    w.write(best_po, 4)
    parts = 1 << best_po
    plen = n // parts
    off = 0
    for p in range(parts):
        cnt = plen - pred_order if p == 0 else plen
        w.write(best_ks[p], pbits)
        _rice_bits(w, res[off : off + cnt], best_ks[p])
        off += cnt


def _write_subframe(w: BitWriter, plan: _SubframePlan, n: int) -> None:
    w.write(0, 1)  # zero pad
    if plan.kind == "constant":
        w.write(0, 6)
        w.write(0, 1)  # no wasted bits
        w.write(int(plan.warmup[0]), plan.bits)
        return
    if plan.kind == "verbatim":
        w.write(1, 6)
        w.write(0, 1)
        for v in plan.warmup:
            w.write(int(v), plan.bits)
        return
    if plan.kind == "fixed":
        w.write(8 | plan.order, 6)
        w.write(0, 1)
        for v in plan.warmup:
            w.write(int(v), plan.bits)
        _write_residual(w, plan.res, n, plan.order)
        return
    # LPC
    w.write(0x20 | (plan.order - 1), 6)
    w.write(0, 1)
    for v in plan.warmup:
        w.write(int(v), plan.bits)
    w.write(plan.precision - 1, 4)
    w.write(plan.shift, 5)
    for c in plan.qlp:
        w.write(int(c), plan.precision)
    _write_residual(w, plan.res, n, plan.order)


class FlacFrameEncoder:
    """Encode [C, n] int blocks as independently decodable FLAC frames
    (frame_codec.rs:42-278 parity: 16/24-bit, profiles realtime /
    balanced / maximum)."""

    def __init__(self, sample_rate: int, channels: int,
                 bits_per_sample: int = 16, profile: str = "balanced"):
        if bits_per_sample not in (16, 24):
            raise ValueError("only 16/24-bit PCM supported (reference parity)")
        if not 1 <= channels <= 8:
            raise ValueError("1..8 channels")
        if not 1 <= sample_rate < (1 << 20):
            raise ValueError("bad sample rate")
        if profile not in ("realtime", "balanced", "maximum"):
            raise ValueError(f"unknown profile {profile!r}")
        self.sample_rate = sample_rate
        self.channels = channels
        self.bits = bits_per_sample
        self.profile = profile
        self._frame_no = 0

    def encode_frame(self, samples: np.ndarray) -> bytes:
        """``samples``: [C, n] ints in the declared bit depth."""
        x = np.atleast_2d(np.asarray(samples, np.int64))
        C, n = x.shape
        if C != self.channels:
            raise ValueError(f"expected {self.channels} channels, got {C}")

        # stereo decorrelation search (independent vs L/S, R/S, M/S)
        assignment = C - 1
        chans = [(x[c], self.bits) for c in range(C)]
        if C == 2:
            L, R = x[0], x[1]
            side = L - R
            mid = (L + R) >> 1
            cost_i = _residual_cost(_fixed_residual(L, 2)) + _residual_cost(
                _fixed_residual(R, 2))
            cost_ls = _residual_cost(_fixed_residual(L, 2)) + _residual_cost(
                _fixed_residual(side, 2))
            cost_rs = _residual_cost(_fixed_residual(side, 2)) + _residual_cost(
                _fixed_residual(R, 2))
            cost_ms = _residual_cost(_fixed_residual(mid, 2)) + _residual_cost(
                _fixed_residual(side, 2))
            bestc = min(cost_i, cost_ls, cost_rs, cost_ms)
            if bestc == cost_ls:
                assignment, chans = 8, [(L, self.bits), (side, self.bits + 1)]
            elif bestc == cost_rs:
                assignment, chans = 9, [(side, self.bits + 1), (R, self.bits)]
            elif bestc == cost_ms:
                assignment, chans = 10, [(mid, self.bits), (side, self.bits + 1)]

        plans = [_plan_subframe(ch, bits, self.profile) for ch, bits in chans]
        return self.write_frame(n, assignment, plans)

    def write_frame(self, n: int, assignment: int, plans) -> bytes:
        """Assemble one frame from precomputed subframe plans (used
        both by encode_frame and by the batched device-analysis path,
        models/flac_encode_batch.py).

        Routes through the native bit-packer
        (native/src/flac_pack.cpp skt_flac_pack_frame1, byte-identical
        to :meth:`write_frame_py`) when the host library is available;
        the pure-Python writer remains the fallback and the
        equivalence oracle (tests/test_flac_encode_native.py).
        """
        lib = _native_lib()
        if lib is None:
            return self.write_frame_py(n, assignment, plans)
        if not 16 <= n <= 65535:
            raise ValueError("block size out of range")
        ns = len(plans)
        kind = np.zeros(ns, np.int32)
        order = np.zeros(ns, np.int32)
        slot_bits = np.zeros(ns, np.int32)
        shift = np.zeros(ns, np.int32)
        warm = np.zeros((ns, n), np.int64)
        res = np.zeros((ns, n), np.int64)
        qlp = np.zeros((ns, 32), np.int32)
        precisions = set()
        for i, p in enumerate(plans):
            kind[i] = _KIND_CODE[p.kind]
            order[i] = p.order
            slot_bits[i] = p.bits
            if p.kind == "constant":
                warm[i, 0] = p.warmup[0]
            elif p.kind == "verbatim":
                warm[i, :n] = p.warmup
            else:
                o = p.order
                warm[i, :o] = p.warmup
                res[i, : n - o] = p.res
                if p.kind == "lpc":
                    shift[i] = p.shift
                    qlp[i, :o] = p.qlp
                    precisions.add(p.precision)
        if len(precisions) > 1:  # mixed precisions: generic path only
            return self.write_frame_py(n, assignment, plans)
        precision = precisions.pop() if precisions else 14
        cap = 256 + ns * n * 6
        out = np.zeros(cap, np.uint8)
        ln = lib.skt_flac_pack_frame1(
            n, self.sample_rate, self.bits, precision, self._frame_no,
            assignment, ns, kind, order, slot_bits, shift,
            warm.reshape(-1), res.reshape(-1), qlp.reshape(-1), out, cap,
        )
        if ln < 0:
            return self.write_frame_py(n, assignment, plans)
        self._frame_no += 1
        return bytes(out[:ln])

    def write_frame_py(self, n: int, assignment: int, plans) -> bytes:
        """Pure-Python frame assembly (fallback + native oracle)."""
        if not 16 <= n <= 65535:
            raise ValueError("block size out of range")
        w = BitWriter()
        w.write(0b11111111111110, 14)
        w.write(0, 1)  # reserved
        w.write(0, 1)  # fixed blocksize strategy
        bs_code = _BLOCK_SIZE_CODES.get(n, 7)
        w.write(bs_code, 4)
        sr_code = _RATE_CODES.get(self.sample_rate, 0)
        if sr_code == 0 and self.sample_rate % 10 == 0 and self.sample_rate // 10 < 65536:
            sr_code = 14
        elif sr_code == 0 and self.sample_rate < 65536:
            sr_code = 13
        w.write(sr_code, 4)
        w.write(assignment, 4)
        w.write(_BITS_CODES[self.bits], 3)
        w.write(0, 1)  # reserved
        for b in _utf8_frame_number(self._frame_no):
            w.write(b, 8)
        if bs_code == 7:
            w.write(n - 1, 16)
        if sr_code == 14:
            w.write(self.sample_rate // 10, 16)
        elif sr_code == 13:
            w.write(self.sample_rate, 16)
        w.write(_crc8(w.bytes()), 8)

        for plan in plans:
            _write_subframe(w, plan, n)
        w.align()
        body = w.bytes()
        self._frame_no += 1
        return body + struct.pack(">H", _crc16(body))

    def reset(self) -> None:
        self._frame_no = 0


class FlacStreamEncoder:
    """Full .flac stream: fLaC marker + STREAMINFO (with MD5) + frames.

    The full-file analog the reference reaches via libFLAC; this one is
    owned end to end and round-trips bit-exactly through
    native/src/flac.cpp including the MD5 check."""

    def __init__(self, sample_rate: int, channels: int,
                 bits_per_sample: int = 16, block_size: int = 4096,
                 profile: str = "balanced"):
        self._enc = FlacFrameEncoder(sample_rate, channels,
                                     bits_per_sample, profile)
        self.block_size = block_size
        self._buf = np.zeros((channels, 0), np.int64)
        self._frames: List[bytes] = []
        self._md5 = hashlib.md5()
        self._total = 0
        self._min_fs = None
        self._max_fs = 0

    def add(self, samples: np.ndarray) -> None:
        """[C, n] ints at the declared bit depth."""
        x = np.atleast_2d(np.asarray(samples, np.int64))
        self._buf = np.concatenate([self._buf, x], axis=1)
        while self._buf.shape[1] >= self.block_size:
            self._emit(self._buf[:, : self.block_size])
            self._buf = self._buf[:, self.block_size:]

    def _emit(self, block: np.ndarray) -> None:
        bps = self._enc.bits
        inter = block.T.reshape(-1)
        if bps == 16:
            self._md5.update(inter.astype("<i2").tobytes())
        else:
            b = inter.astype("<i4").tobytes()
            arr = np.frombuffer(b, np.uint8).reshape(-1, 4)[:, :3]
            self._md5.update(arr.tobytes())
        self._total += block.shape[1]
        frame = self._enc.encode_frame(block)
        self._min_fs = len(frame) if self._min_fs is None else min(self._min_fs, len(frame))
        self._max_fs = max(self._max_fs, len(frame))
        self._frames.append(frame)

    def finish(self) -> bytes:
        if self._buf.shape[1] >= 16:
            self._emit(self._buf)
            self._buf = self._buf[:, :0]
        elif self._buf.shape[1] > 0:
            # pad the sub-minimum tail to 16 samples of held last value
            pad = 16 - self._buf.shape[1]
            tail = np.concatenate(
                [self._buf, np.repeat(self._buf[:, -1:], pad, axis=1)], axis=1
            )
            self._emit(tail)
            self._buf = self._buf[:, :0]

        enc = self._enc
        info = BitWriter()
        info.write(self.block_size, 16)  # min block
        info.write(self.block_size, 16)  # max block (last may differ; allowed)
        info.write(self._min_fs or 0, 24)
        info.write(self._max_fs, 24)
        info.write(enc.sample_rate, 20)
        info.write(enc.channels - 1, 3)
        info.write(enc.bits - 1, 5)
        info.write(self._total, 36)
        md5 = self._md5.digest()
        for b in md5:
            info.write(b, 8)
        si = info.bytes()
        header = b"fLaC" + bytes([0x80]) + len(si).to_bytes(3, "big") + si
        return header + b"".join(self._frames)
