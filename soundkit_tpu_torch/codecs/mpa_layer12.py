"""MPEG audio Layer I and Layer II decoder (host, numpy).

The JAX package's ``Mp3Decoder`` hands a stream whose first header is
Layer I or II to libavcodec (``soundkit_tpu/codecs/mp3.py``, ``_use_av``).
The port builds no FFmpeg, so :class:`MpaLayer12Decoder` decodes these
streams itself: MPEG-1, MPEG-2 LSF and MPEG-2.5, Layer I and Layer II,
mono, stereo, joint (intensity) stereo and dual channel, with or without
the CRC word (read and not checked, as libavcodec does by default).

Framing follows libavcodec's MPEG audio parser and ``decode_frame`` so
that a whole stream gives the same frames:

- after each frame the parser looks for the next valid header (sync,
  version, layer, bit rate other than 0 and 15, rate other than 3) and
  cuts a packet at the end of that frame, so a packet is the bytes since
  the previous frame's end up to this frame's end. A frame is emitted as
  soon as its last byte is pushed;
- a packet decodes only if it starts with the header once its leading
  zero bytes are skipped: junk (an ID3v2 tag too) before a frame costs
  that frame, zero bytes cost nothing;
- at :meth:`MpaLayer12Decoder.flush` the bytes pending form a last
  packet; a truncated frame decodes with zero bits past its end (the
  parser's zeroed padding);
- a Layer III or free-format frame in such a stream yields nothing.

Per frame: the allocation (Layer II: the table chosen by version, rate
and bit rate per channel, as ``ff_mpa_l2_select_table``), scfsi and
scalefactors, then every sample code of the frame read in one numpy
gather from bit positions that the allocation fixes, requantized in
``2 (code - steps // 2) / steps`` times ``2 ** (1 - sf / 3)`` (three
samples of a grouped code are its base-``steps`` digits) in integers at
2**23, rounded as libavcodec's ``l1_unscale`` / ``l2_unscale_group``
round, then the 32-band polyphase synthesis in float64 (matrixing, and
the 512-tap window over the carried 1024-sample FIFO of each channel,
kept as its last 15 matrixed slots), rounded to float32 at the output.
libavcodec synthesizes in float32, so the two agree closely, not bit for
bit. (An exact float64 unscale would lie about 2**-24 of full scale from
libavcodec's, which a quiet stream would feel.)

The tables come from ``data/mpa_tables.npz`` (``tools/extract_mpa_tables.py``).
"""
from __future__ import annotations

import functools
from pathlib import Path
from typing import List, Optional, Tuple

import numpy as np

_DATA = Path(__file__).resolve().parent.parent / "data" / "mpa_tables.npz"

MONO, JOINT_STEREO = 3, 1
_PAD = 8  # zero bytes after a frame: a truncated frame reads zeros


@functools.lru_cache(maxsize=1)
def _tables() -> dict:
    with np.load(_DATA) as z:
        t = {k: z[k] for k in z.files}
    # per allocation table: each subband's width and its 16 classes
    # (class -1 for codes past the width)
    classes, nbal = [], []
    for k in range(5):
        a = t[f"alloc_{k}"].astype(np.int64)
        cl = np.full((int(t["sblimit"][k]), 16), -1, np.int64)
        nb = np.zeros(int(t["sblimit"][k]), np.int64)
        j = 0
        for i in range(len(nb)):
            nb[i] = a[j]
            cl[i, 1:1 << a[j]] = a[j + 1:j + (1 << a[j])]
            j += 1 << a[j]
        classes.append(cl)
        nbal.append(nb)
    t["classes"], t["nbal"] = classes, nbal
    # the synthesis window D (ISO/IEC 11172-3 Table 3-B.3) from its 257
    # stored taps, as libavcodec's ff_mpa_synth_init lays it out
    win = np.zeros(512)
    for i in range(257):
        v = float(t["enwindow"][i])
        win[i] = v
        if i:
            win[512 - i] = -v if i & 63 else v
    win /= 65536.0
    t["d0"] = np.stack([win[64 * i:64 * i + 32] for i in range(8)])  # [8, 32]
    t["d1"] = np.stack([win[64 * i + 32:64 * i + 64] for i in range(8)])
    # libavcodec's unscale multipliers at 2**23 (mpegaudiodec_template.c):
    # ungrouped codes of 2..16 bits, norm 2**n 2**23 / (2**n - 1) times
    # 2 * 2**(-mod / 3) in float32, truncated as its float build stores them;
    # grouped codes of 3 / 5 / 9 steps, 4 / steps * 2**(-mod / 3) rounded
    mods = (1.0, 0.7937005259, 0.6299605249)
    norm = [((1 << n) << 23) // ((1 << n) - 1) for n in range(2, 17)]
    t["mult1"] = np.array([[int(np.float32(np.float32(2.0 * m) * np.float32(v))) for m in mods]
                           for v in norm], np.int64)
    t["mult2"] = np.array([[int(m * 4.0 / st * (1 << 23) + 0.5) for m in mods]
                           for st in (3.0, 5.0, 9.0)], np.int64)
    k = np.arange(32)
    t["matrix"] = np.cos((16 + np.arange(64))[:, None] * (2 * k + 1)[None, :] * np.pi / 64)
    return t


class Header:
    """One 32-bit MPEG audio header, as libavcodec's
    ``avpriv_mpegaudio_decode_header`` reads it."""

    __slots__ = ("layer", "lsf", "mpeg25", "rate", "bitrate", "padding", "mode", "mode_ext",
                 "crc", "channels", "frame_size")

    def __init__(self, h: int) -> None:
        t = _tables()
        if h & (1 << 20):
            self.lsf, self.mpeg25 = (0 if h & (1 << 19) else 1), 0
        else:
            self.lsf, self.mpeg25 = 1, 1
        self.layer = 4 - ((h >> 17) & 3)
        self.rate = int(t["freq_tab"][(h >> 10) & 3]) >> (self.lsf + self.mpeg25)
        self.crc = not (h >> 16) & 1
        self.padding = (h >> 9) & 1
        self.mode = (h >> 6) & 3
        self.mode_ext = (h >> 4) & 3
        self.channels = 1 if self.mode == MONO else 2
        kbps = int(t["bitrate_tab"][self.lsf, self.layer - 1, (h >> 12) & 15])
        self.bitrate = kbps
        if self.layer == 1:
            self.frame_size = (kbps * 12000 // self.rate + self.padding) * 4
        elif self.layer == 2:
            self.frame_size = kbps * 144000 // self.rate + self.padding
        else:
            self.frame_size = kbps * 144000 // (self.rate << self.lsf) + self.padding


def parse_header(b: bytes, i: int = 0) -> Optional[Header]:
    """The header at ``b[i:i + 4]`` if it is one libavcodec's parser takes
    (its ``ff_mpa_check_header``, and a bit rate index other than 0: free
    format has no frame size), else None."""
    if len(b) < i + 4 or b[i] != 0xFF or (b[i + 1] & 0xE0) != 0xE0:
        return None
    if (b[i + 1] >> 3) & 3 == 1 or (b[i + 1] >> 1) & 3 == 0:
        return None
    if (b[i + 2] >> 4) in (0, 15) or (b[i + 2] >> 2) & 3 == 3:
        return None
    return Header(int.from_bytes(b[i:i + 4], "big"))


def select_table(bitrate_kbps: int, channels: int, rate: int, lsf: int) -> int:
    """The Layer II allocation table (``ff_mpa_l2_select_table``)."""
    if lsf:
        return 4
    ch_bitrate = bitrate_kbps // channels
    if (rate == 48000 and ch_bitrate >= 56) or 56 <= ch_bitrate <= 80:
        return 0
    if rate != 48000 and ch_bitrate >= 96:
        return 1
    if rate != 32000 and ch_bitrate <= 48:
        return 2
    return 3


def _read(buf: np.ndarray, pos: np.ndarray, width: np.ndarray) -> np.ndarray:
    """The unsigned ``width``-bit fields (at most 16 bits) that start at the
    bit positions ``pos`` of the big-endian byte array ``buf``."""
    i = np.minimum(pos >> 3, buf.size - 4)  # past the end: the zero padding
    word = (buf[i] << 24) | (buf[i + 1] << 16) | (buf[i + 2] << 8) | buf[i + 3]
    return (word >> (32 - (pos & 7) - width)) & ((1 << width) - 1)


def _fields(buf: np.ndarray, pos: int, width: np.ndarray) -> Tuple[np.ndarray, int]:
    """Consecutive fields of the given widths from bit ``pos`` on, and the
    position after them."""
    width = np.asarray(width, np.int64)
    if width.size == 0:
        return width, pos
    starts = pos + np.concatenate(([0], np.cumsum(width)[:-1]))
    return _read(buf, starts, width), pos + int(width.sum())


def _digits(vals: np.ndarray, fidx: np.ndarray, div: np.ndarray, mod: np.ndarray) -> np.ndarray:
    """The codes of the entries' three samples: ``vals`` [G, F] the fields
    read, ``fidx`` / ``div`` / ``mod`` [E, 3] which field holds each sample
    and which base-``steps`` digit of it (``mod`` 0: the whole quotient)."""
    q = vals[:, fidx] // div
    return np.where(mod > 0, q % np.maximum(mod, 1), q)


def _unscale(d: np.ndarray, bits: np.ndarray, steps: np.ndarray, grouped: np.ndarray,
             sf: np.ndarray) -> np.ndarray:
    """Subband samples of codes less their midpoint (``d = code - steps //
    2``) under scalefactor indexes ``sf``: ``2 d / steps * 2 ** (1 - sf /
    3)``, as libavcodec computes it at 2**23 in integers (``l1_unscale``,
    ``l2_unscale_group``), rounding included, then scaled to 1.0. The
    arrays broadcast together; ``bits`` is the code's width (ungrouped)."""
    t = _tables()
    shift, mod = sf // 3, sf % 3
    n = np.clip(bits - 1, 1, 15)
    s1 = shift + n
    ungrouped = (d * t["mult1"][n - 1, mod] + (1 << (s1 - 1))) >> s1
    g = d * t["mult2"][np.clip(steps >> 2, 0, 2), mod]
    grouped_v = np.where(shift > 0, (g + (1 << np.maximum(shift - 1, 0))) >> shift, g)
    return np.where(grouped, grouped_v, ungrouped) * (1.0 / (1 << 23))


class MpaLayer12Decoder:
    """Streaming Layer I / II decoder: :meth:`push` bytes in chunks of any
    size and get interleaved float32 PCM; :meth:`flush` at the end."""

    def __init__(self) -> None:
        self._pending = bytearray()  # bytes since the last frame's end
        self._scan = 0  # where the header search resumes in ``_pending``
        self._end = 0  # the current frame's end in ``_pending`` (0: none yet)
        self._hist = np.zeros((2, 15, 64))  # the last 15 matrixed slots a channel
        self.rate = 0
        self.channels = 0

    # -- framing ------------------------------------------------------------

    def push(self, data: bytes) -> np.ndarray:
        self._pending += data
        outs: List[np.ndarray] = []
        while True:
            if not self._end:
                hdr_at = self._find_header()
                if hdr_at is None:
                    break
                self._end = hdr_at + Header(int.from_bytes(
                    self._pending[hdr_at:hdr_at + 4], "big")).frame_size
            if len(self._pending) < self._end:
                break
            packet = bytes(self._pending[:self._end])
            del self._pending[:self._end]
            self._scan = self._end = 0
            outs.append(self._decode_packet(packet))
        return np.concatenate(outs) if outs else np.zeros(0, np.float32)

    def flush(self) -> np.ndarray:
        packet, self._pending = bytes(self._pending), bytearray()
        self._scan = self._end = 0
        return self._decode_packet(packet) if packet else np.zeros(0, np.float32)

    def _find_header(self) -> Optional[int]:
        p = self._pending
        i = self._scan
        while True:
            i = p.find(b"\xff", i)
            if i < 0 or i + 4 > len(p):
                self._scan = len(p) if i < 0 else i
                return None
            if parse_header(p, i) is not None:
                return i
            i += 1

    def _decode_packet(self, packet: bytes) -> np.ndarray:
        body = packet.lstrip(b"\x00")
        hdr = parse_header(body)
        if hdr is None or hdr.layer == 3:
            return np.zeros(0, np.float32)
        body = body[:hdr.frame_size]
        buf = np.zeros(max(len(body), hdr.frame_size) + _PAD, np.int64)
        buf[:len(body)] = np.frombuffer(body, np.uint8)
        pos = 32 + (16 if hdr.crc else 0)
        sb = self._layer1(hdr, buf, pos) if hdr.layer == 1 else self._layer2(hdr, buf, pos)
        pcm = self._synth(sb)  # [C, T * 32]
        self.rate, self.channels = hdr.rate, hdr.channels
        return pcm.T.reshape(-1).astype(np.float32)

    # -- Layer I ------------------------------------------------------------

    def _layer1(self, hdr: Header, buf: np.ndarray, pos: int) -> np.ndarray:
        nch = hdr.channels
        bound = (hdr.mode_ext + 1) * 4 if hdr.mode == JOINT_STEREO else 32
        # (subband, channel) entries in bitstream order; past the bound one
        # entry codes both channels
        sb_i, _ = _entry_layout(bound, 32, nch)
        alloc, pos = _fields(buf, pos, np.full(sb_i.size, 4))
        # scalefactors: one an allocated (subband, channel) pair, both
        # channels past the bound
        oi, oc = _output_layout(32, nch)
        ent = _output_entry(bound, 32, nch)
        have = alloc[ent] > 0
        sf, pos = _fields(buf, pos, np.where(have, 6, 0))
        # 12 slots of the entries' codes, each n + 1 bits
        width = np.where(alloc > 0, alloc + 1, 0)
        slot_bits = int(width.sum())
        starts = np.concatenate(([0], np.cumsum(width)[:-1]))
        g = np.arange(12)
        vals = _read(buf, pos + g[:, None] * slot_bits + starts[None, :],
                     np.broadcast_to(width, (12, width.size)))
        d = vals - ((1 << alloc) - 1)  # code less its midpoint, [12, E]
        sb = np.zeros((nch, 12, 32))
        # every (subband, channel) pair reads its entry's code
        val = _unscale(d[:, ent], alloc[ent] + 1, 0, False, sf)
        sb[oc[None, :], g[:, None], oi[None, :]] = np.where(have, val, 0.0)
        return sb

    # -- Layer II -----------------------------------------------------------

    def _layer2(self, hdr: Header, buf: np.ndarray, pos: int) -> np.ndarray:
        t = _tables()
        nch = hdr.channels
        table = select_table(hdr.bitrate, nch, hdr.rate, hdr.lsf)
        sblimit = int(t["sblimit"][table])
        classes, nbal = t["classes"][table], t["nbal"][table]
        bound = (hdr.mode_ext + 1) * 4 if hdr.mode == JOINT_STEREO else sblimit
        bound = min(bound, sblimit)
        sb_i, _ = _entry_layout(bound, sblimit, nch)
        alloc, pos = _fields(buf, pos, nbal[sb_i])
        # scfsi, then the scalefactors, for every allocated (subband, channel)
        oi, oc = _output_layout(sblimit, nch)
        ent = _output_entry(bound, sblimit, nch)
        have = alloc[ent] > 0
        scfsi, pos = _fields(buf, pos, np.where(have, 2, 0))
        count = np.where(have, np.array([3, 2, 1, 2])[scfsi], 0)
        sfv, pos = _fields(buf, pos, np.repeat(6, int(count.sum())))
        first = np.concatenate(([0], np.cumsum(count)[:-1]))
        # the three parts' scalefactors from the values read: scfsi 0 ->
        # (a, b, c), 1 -> (a, a, c), 2 -> (a, a, a), 3 -> (a, c, c)
        pick = np.array([[0, 1, 2], [0, 0, 1], [0, 0, 0], [0, 1, 1]])[scfsi[have]]
        sf3 = np.zeros((have.size, 3), np.int64)  # [O, 3]
        sf3[have] = sfv[first[have, None] + pick]
        # the sample codes of the entries: grouped classes take one field of
        # three base-steps digits, the others three fields
        q = classes[sb_i, alloc]
        live = alloc > 0
        qb = np.where(live, t["quant_bits"][np.maximum(q, 0)], 0).astype(np.int64)
        steps = np.where(live, t["quant_steps"][np.maximum(q, 0)], 1).astype(np.int64)
        grouped = qb < 0
        nfield = np.where(live, np.where(grouped, 1, 3), 0)
        fwidth = np.repeat(np.abs(qb), nfield)
        f0 = np.concatenate(([0], np.cumsum(nfield)[:-1]))
        m = np.arange(3)
        fidx = np.where(grouped[:, None], f0[:, None], f0[:, None] + m)
        fidx = np.minimum(fidx, max(fwidth.size - 1, 0))
        div = np.where(grouped[:, None], steps[:, None] ** m, 1)
        mod = np.where(grouped[:, None] & (m < 2), steps[:, None], 0)
        gran_bits = int(fwidth.sum())
        fstart = np.concatenate(([0], np.cumsum(fwidth)[:-1]))
        g = np.arange(12)
        if fwidth.size:
            vals = _read(buf, pos + g[:, None] * gran_bits + fstart[None, :],
                         np.broadcast_to(fwidth, (12, fwidth.size)))
            d = _digits(vals, fidx, div, mod) - (steps // 2)[:, None]  # [12, E, 3]
        else:
            d = np.zeros((12, sb_i.size, 3), np.int64)
        # granule g is part g // 4 of the frame; its samples are slots 3g..3g+2
        val = _unscale(d[:, ent, :], np.abs(qb[ent])[:, None], steps[ent][:, None],
                       grouped[ent][:, None], sf3[:, g // 4].T[:, :, None])  # [12, O, 3]
        val = np.where(have[None, :, None], val, 0.0)
        sb = np.zeros((nch, 36, 32))
        sb[oc[None, :, None], (3 * g)[:, None, None] + m[None, None, :], oi[None, :, None]] = val
        return sb

    # -- synthesis ----------------------------------------------------------

    def _synth(self, sb: np.ndarray) -> np.ndarray:
        """[C, T, 32] subband samples -> [C, T * 32] PCM, carrying each
        channel's FIFO."""
        t = _tables()
        nch, n_slots, _ = sb.shape
        out = np.empty((nch, n_slots * 32))
        rows = 15 + np.arange(n_slots)[:, None] - 2 * np.arange(8)[None, :]  # [T, 8]
        for c in range(nch):
            v = np.concatenate([self._hist[c], sb[c] @ t["matrix"].T])  # [15 + T, 64]
            a = v[rows, :32]  # [T, 8, 32]
            b = v[rows - 1, 32:]
            out[c] = (np.einsum("tij,ij->tj", a, t["d0"])
                      + np.einsum("tij,ij->tj", b, t["d1"])).reshape(-1)
            self._hist[c] = v[-15:]
        return out


@functools.lru_cache(maxsize=None)
def _entry_layout(bound: int, sblimit: int, nch: int) -> Tuple[np.ndarray, np.ndarray]:
    """Subband and channel of each coded entry in bitstream order: every
    channel below ``bound``, channel 0 alone (for both) from it to ``sblimit``."""
    sb = [i for i in range(bound) for _ in range(nch)] + list(range(bound, sblimit))
    ch = [c for _ in range(bound) for c in range(nch)] + [0] * (sblimit - bound)
    return np.array(sb, np.int64), np.array(ch, np.int64)


@functools.lru_cache(maxsize=None)
def _output_layout(sblimit: int, nch: int) -> Tuple[np.ndarray, np.ndarray]:
    """Subband and channel of every (subband, channel) pair, subband-major."""
    sb = np.repeat(np.arange(sblimit), nch)
    ch = np.tile(np.arange(nch), sblimit)
    return sb.astype(np.int64), ch.astype(np.int64)


@functools.lru_cache(maxsize=None)
def _output_entry(bound: int, sblimit: int, nch: int) -> np.ndarray:
    """For each (subband, channel) pair of :func:`_output_layout`, the
    entry of :func:`_entry_layout` that codes it."""
    sb, ch = _entry_layout(bound, sblimit, nch)
    where = {(int(i), int(c)): e for e, (i, c) in enumerate(zip(sb, ch))}
    oi, oc = _output_layout(sblimit, nch)
    return np.array([where[(int(i), int(c) if i < bound else 0)] for i, c in zip(oi, oc)],
                    np.int64)
