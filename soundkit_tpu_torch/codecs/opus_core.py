"""RFC 6716 top level: TOC parsing, frame packing (§3), and the
packet decoder that routes to the owned CELT layer (opus_celt.py,
mono+stereo) and the owned SILK layer (opus_silk.py, mono NB/MB/WB
with the oracle-matched resampler in utils/swr.py).

All modes are owned: CELT and SILK in mono and stereo (mid/side
unmix, LBRR, midonly, mono-coded packets in stereo streams), and
hybrid (SILK-WB + CELT start band 17 sharing one range coder with
redundancy signalling kept in sync).
Parity reference: soundkit-opus/src/lib.rs (libopus wrapper).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

import numpy as np

from soundkit_tpu_torch.codecs.opus_rc import RangeDecoder
from soundkit_tpu_torch.codecs.opus_celt import CeltDecoder
from soundkit_tpu_torch.codecs.opus_tables import tables


def _native_silk_cls():
    """The C++ SILK stage class, or None if the native library is
    unavailable (the Python decoder then runs the LP layer)."""
    try:
        from soundkit_tpu_torch.codecs.silk_native import NativeSilkDecoder
        return NativeSilkDecoder
    except Exception:
        return None


class OpusUnsupported(ValueError):
    pass


@dataclass(frozen=True)
class Toc:
    config: int
    stereo: bool
    code: int

    @property
    def mode(self) -> str:
        if self.config < 12:
            return "silk"
        if self.config < 16:
            return "hybrid"
        return "celt"

    @property
    def frame_duration(self) -> float:
        """Frame duration in ms."""
        c = self.config
        if c < 12:
            return (10, 20, 40, 60)[c % 4]
        if c < 16:
            return (10, 20)[c % 2]
        return (2.5, 5, 10, 20)[c % 4]

    @property
    def bandwidth(self) -> int:
        """0=NB 1=MB 2=WB 3=SWB 4=FB."""
        c = self.config
        if c < 12:
            return (0, 1, 2)[c // 4]
        if c < 16:
            return 3 + (c - 12) // 2
        return (0, 2, 3, 4)[(c - 16) // 4]


_TOC_CACHE = tuple(
    Toc(tb >> 3, bool((tb >> 2) & 1), tb & 3) for tb in range(256)
)

# (mode, frame_duration_ms, stereo, bandwidth, code) per TOC byte:
# the serving hot paths classify ~75k packets per 1024-stream fleet
# collect, so the Toc properties are pre-evaluated once here
TOC_ATTRS = tuple(
    (t.mode, t.frame_duration, t.stereo, t.bandwidth, t.code)
    for t in _TOC_CACHE
)


def parse_packet(data: bytes) -> tuple:
    """Split an Opus packet into (Toc, [frame bytes]) per RFC §3.2.

    ``data`` must be ``bytes``: the code-0 fast path returns
    ``data[1:]`` without copying, which aliases mutable input if a
    caller ever passed bytearray/memoryview (none do)."""
    if len(data) < 1:
        raise OpusUnsupported("empty packet")
    toc = _TOC_CACHE[data[0]]
    if toc.code == 0:
        # serving fast path: code-0 packets (one frame, no length
        # fields) are the whole fixture corpus — skip the body copy
        # and the per-call Toc construction (the fleet parses ~75k
        # packets per 1024-stream collect)
        return toc, [data[1:]]
    body = data[1:]

    def read_len(b, pos):
        if pos >= len(b):
            raise OpusUnsupported("truncated packet")
        v = b[pos]
        pos += 1
        if v >= 252:
            if pos >= len(b):
                raise OpusUnsupported("truncated packet")
            v += 4 * b[pos]
            pos += 1
        return v, pos

    if toc.code == 1:
        if len(body) % 2:
            raise OpusUnsupported("code 1 with odd payload")
        h = len(body) // 2
        frames = [bytes(body[:h]), bytes(body[h:])]
    elif toc.code == 2:
        n1, pos = read_len(body, 0)
        if n1 > len(body) - pos:
            raise OpusUnsupported("bad code 2 length")
        frames = [bytes(body[pos : pos + n1]), bytes(body[pos + n1 :])]
    else:
        if len(body) < 1:
            raise OpusUnsupported("truncated code 3")
        fc = body[0] & 0x3F
        vbr = bool(body[0] & 0x80)
        pad = bool(body[0] & 0x40)
        pos = 1
        if fc == 0:
            raise OpusUnsupported("zero frame count")
        padding = 0
        if pad:
            while True:
                if pos >= len(body):
                    raise OpusUnsupported("truncated padding")
                p = body[pos]
                pos += 1
                padding += 254 if p == 255 else p
                if p != 255:
                    break
        avail = len(body) - padding
        if vbr:
            lens = []
            for _ in range(fc - 1):
                n, pos = read_len(body, pos)
                lens.append(n)
            rest = avail - pos - sum(lens)
            if rest < 0:
                raise OpusUnsupported("bad vbr lengths")
            lens.append(rest)
        else:
            rest = avail - pos
            if rest % fc:
                raise OpusUnsupported("bad cbr split")
            lens = [rest // fc] * fc
        frames = []
        for n in lens:
            frames.append(bytes(body[pos : pos + n]))
            pos += n
    return toc, frames


def packet_duration_48k(data: bytes) -> int:
    """Per-channel sample count a packet decodes to at 48 kHz.

    Deterministic from the TOC alone (RFC 6716 §3.1: frame count x
    frame duration); 0 for packets that don't parse.  Used by the
    replay-history trimming in codecs/opus.py to account for dropped
    prefix packets without decoding them.
    """
    try:
        toc, frames = parse_packet(data)
    except Exception:
        return 0
    return int(len(frames) * toc.frame_duration * 48)


class OpusDecoder:
    """Owned Opus packet decoder (48 kHz float output).

    CELT modes decode through opus_celt.py, SILK through
    opus_silk.py + the oracle-matched resampler, hybrid through both
    on one shared coder; mono and stereo are owned end to end."""

    def __init__(self, channels: int = 1):
        self.channels = channels
        self.use_native_silk = True
        self.celt = CeltDecoder(channels)
        self._silk = None
        self._resampler = None
        self._delayed = 0       # oracle's delayed_samples (resampler
        self._fade_delay = 0    # shortfall; NB start = 24)
        self._red_pending = None  # clipped pos=0 fade tail -> next pkt
        t = tables()
        self._band_end = t["celt_band_end"].astype(int)
        self._w2 = t["celt_window2"].astype(np.float64)
        self._last_duration = 960

    def _decode_silk_frame(self, rc: RangeDecoder, toc: Toc,
                           force_wb: bool = False) -> np.ndarray:
        from soundkit_tpu_torch.codecs.opus_silk import SilkDecoder
        from soundkit_tpu_torch.utils.silk_resampler import SilkResampler

        coded = 2 if toc.stereo else 1
        if coded > self.channels:
            raise OpusUnsupported("stereo packet in a mono stream")
        # hybrid runs SILK at WB regardless of the packet bandwidth
        bw = 2 if force_wb else toc.bandwidth  # 0=NB 1=MB 2=WB
        if self._silk is None:
            cls = (_native_silk_cls()
                   if self.use_native_silk else None)
            self._silk = cls() if cls is not None else SilkDecoder()
        flush = np.zeros((0, self.channels))
        if self._resampler is None or self._resampler_bw != bw:
            # bandwidth switch: the oracle drains the old resampler's
            # pending delayed_samples into the output, then reinits
            # (opusdec opus_flush_resample)
            if self._resampler is not None and self._delayed > 0:
                flush = np.asarray(
                    self._resampler.drain(self._delayed),
                    dtype=np.float64)
            self._delayed = 0
            rate = (8000, 12000, 16000)[bw]
            self._resampler = SilkResampler(rate, bw, self.channels)
            self._resampler_bw = bw
        duration_ms = int(toc.frame_duration)
        if hasattr(self._silk, "_h"):
            # native stage: decodes from the frame start and exports
            # the final coder state back into the caller's rc so the
            # redundancy/hybrid logic below continues unchanged
            pcm, _, st = self._silk.decode_superframe(
                rc.buf, bw, coded, duration_ms, False)
            rc.set_state(st)
        else:
            pcm = self._silk.decode_superframe(rc, bw, coded,
                                               duration_ms)
        if coded < self.channels:
            pcm = np.repeat(pcm, self.channels, axis=1)
        self._fade_delay = self._delayed
        out48 = self._resampler.process(pcm, duration_ms * 48)
        self._delayed += duration_ms * 48 - out48.shape[0]
        return flush, out48.astype(np.float64)

    def _decode_redundancy(self, data: bytes, toc: Toc,
                           coded: int) -> np.ndarray:
        """5 ms CELT redundancy frame from the packet's trailing bytes
        (opusdec's opus_decode_redundancy). SILK MB promotes to WB."""
        bw = toc.bandwidth
        if toc.mode == "silk" and bw == 1:
            bw = 2
        rc = RangeDecoder(data)
        red = self.celt.decode_frame(rc, 240, 0,
                                     int(self._band_end[bw]), coded)
        if red.shape[0] < self.channels:
            red = np.repeat(red, self.channels, axis=0)
        return red  # [channels, 240]

    def _apply_redundancy_fade(self, out: np.ndarray, red: np.ndarray,
                               pos: int) -> None:
        """Crossfade with ff_celt_window2, in our time-aligned frame
        grid (the oracle's delayed_samples bookkeeping cancels out
        because our resampler emits full frames):
        - pos=1 (redundancy first, celt->silk): the frame's first 120
          samples ARE the redundancy, then fade redundancy -> frame.
        - pos=0 (redundancy last, silk->celt): fade the frame's last
          120 samples into the redundancy's second half; the carry
          into the next frame collapses onto the same window."""
        w2 = self._w2[:, None]
        r = red.T  # [240, channels]
        if pos:
            out[:120] = r[:120]
            out[120:240] = out[120:240] * w2 + r[120:240] * (1.0 - w2)
        else:
            # the oracle fades at samples-120+delayed_samples; the
            # window tail past the frame end continues onto the next
            # packet's first samples (opusdec redundancy_idx)
            S = out.shape[0]
            d = min(self._fade_delay, 120)
            k = 120 - d
            out[S - k:] = (out[S - k:] * (1.0 - w2[:k])
                           + r[120:120 + k] * w2[:k])
            if d > 0:
                self._red_pending = (red.copy(), k)

    def _silk_transition(self, rc: RangeDecoder, toc: Toc, f: bytes,
                         out: np.ndarray) -> np.ndarray:
        """Post-SILK redundancy handling for SILK-only frames (opusdec
        opus_decode_frame): any spare bytes after the SILK payload are
        a 5 ms CELT redundancy frame; the CELT state is flushed on
        every SILK frame, and a pos=0 redundancy decode seeds the
        flushed state so the next CELT frame predicts from it."""
        total = rc.total_bits
        tell = rc.tell()
        coded = 2 if toc.stereo else 1
        red = None
        pos = 0
        # guard calibrated against the oracle: trailing bytes become a
        # redundancy frame once >= 17 bits of slack remain
        if tell + 17 <= total:
            pos = rc.dec_bit_logp(1)
            red_size = len(f) - ((tell + 7) >> 3)
            main_size = len(f) - red_size
            if red_size >= 1 and main_size >= 0:
                if pos:
                    # redundancy continues the PREVIOUS celt stream:
                    # decode with the current state, then flush
                    red = self._decode_redundancy(
                        f[main_size:main_size + red_size], toc, coded)
                self.celt.reset()
                if not pos:
                    # decode on the flushed state; it persists into
                    # the next (celt) frame's predictors
                    red = self._decode_redundancy(
                        f[main_size:main_size + red_size], toc, coded)
            else:
                self.celt.reset()
        else:
            self.celt.reset()
        if red is not None:
            self._apply_redundancy_fade(out, red, pos)
        return out

    def _decode_hybrid_frame(self, rc: RangeDecoder, toc: Toc,
                             frame_len: int) -> np.ndarray:
        """SILK-WB low band + CELT (start band 17) high band sharing
        one range coder; outputs are summed at 48 kHz, with mode-
        transition redundancy decoded and crossfaded as the oracle
        does."""
        silk_flush, silk48 = self._decode_silk_frame(
            rc, toc, force_wb=True)
        total = rc.total_bits
        redundancy = 0
        pos = 0
        red_bytes = None
        coded = 2 if toc.stereo else 1
        # +37 in this tell convention (the flag is logp-12, so the
        # 32-bit window between this and the earlier +5 guard is
        # observationally empty on encoder output; +37 is asm-exact)
        if rc.tell() + 37 <= total:
            redundancy = rc.dec_bit_logp(12)
        if redundancy:
            pos = rc.dec_bit_logp(1)
            red_size = rc.dec_uint(256) + 2
            main_size = max(rc.storage - red_size, rc.offs)
            red_bytes = bytes(rc.buf[main_size:main_size + red_size])
            # the trailing redundancy bytes are not part of the main
            # frame's raw-bit region
            rc.storage = main_size
        red = None
        if redundancy and pos:
            # redundancy continues the previous stream's celt; decode
            # with the current state, then flush for the main frame
            red = self._decode_redundancy(red_bytes, toc, coded)
            self.celt.reset()
        frame_size = int(toc.frame_duration * 48)
        end = int(self._band_end[toc.bandwidth])
        celt = self.celt.decode_frame(rc, frame_size, 17, end, coded)
        if coded < self.channels:
            celt = np.repeat(celt, self.channels, axis=0)
        if redundancy and not pos:
            red = self._decode_redundancy(red_bytes, toc, coded)
        n = min(len(silk48), celt.shape[1])
        out = silk48[:n] + celt.T[:n]
        if red is not None:
            self._apply_redundancy_fade(out, red, pos)
        if silk_flush.shape[0]:
            out = np.concatenate([silk_flush, out], axis=0)
        return out

    def decode_packet(self, data: bytes) -> np.ndarray:
        """One packet -> [n, channels] float64 at 48 kHz."""
        pend = self._red_pending
        self._red_pending = None
        res = self._decode_packet_inner(data)
        if pend is not None and res.shape[0]:
            red, idx = pend
            n = min(120 - idx, res.shape[0])
            w = self._w2[idx:idx + n][:, None]
            res[:n] = (res[:n] * (1.0 - w)
                       + red.T[120 + idx:120 + idx + n] * w)
        return res

    def _decode_packet_inner(self, data: bytes) -> np.ndarray:
        if not data:
            # PLC: decay through the overlap buffer
            n = self._last_duration
            return np.zeros((n, self.channels))
        toc, frames = parse_packet(data)
        if toc.mode == "hybrid":
            outs = []
            for f in frames:
                rc = RangeDecoder(f)
                outs.append(self._decode_hybrid_frame(rc, toc, len(f)))
            self._last_duration = int(toc.frame_duration * 48)
            return np.concatenate(outs, axis=0)
        if toc.mode == "silk":
            outs = []
            for f in frames:
                rc = RangeDecoder(f)
                flush, out = self._decode_silk_frame(rc, toc)
                if flush.shape[0]:
                    outs.append(flush)
                outs.append(self._silk_transition(rc, toc, f, out))
            self._last_duration = int(toc.frame_duration * 48)
            return np.concatenate(outs, axis=0)
        # celt-only frames flush the LP layer (opusdec: ff_silk_flush
        # + swr_close, draining pending delayed_samples first) so a
        # later SILK span restarts from scratch
        silk_flush = np.zeros((0, self.channels))
        if self._silk is not None:
            self._silk = None
        if self._resampler is not None and self._delayed > 0:
            silk_flush = np.asarray(
                self._resampler.drain(self._delayed), dtype=np.float64)
        self._delayed = 0
        self._resampler = None
        frame_size = int(toc.frame_duration * 48)
        self._last_duration = frame_size
        end = int(self._band_end[toc.bandwidth])
        coded = 2 if toc.stereo else 1
        if coded > self.channels:
            raise OpusUnsupported("stereo packet in a mono stream")
        outs = [silk_flush] if silk_flush.shape[0] else []
        for f in frames:
            rc = RangeDecoder(f)
            pcm = self.celt.decode_frame(rc, frame_size, 0, end, coded)
            if coded < self.channels:
                pcm = np.repeat(pcm, self.channels, axis=0)
            outs.append(pcm.T)
        return np.concatenate(outs, axis=0)
