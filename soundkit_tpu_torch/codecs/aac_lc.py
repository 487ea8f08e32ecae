"""From-scratch AAC-LC access-unit decoder (host syntax layer).

Behavioral parity target: the reference's own pure-Rust
``soundkit-aac-lc`` (9.3k LoC), its flagship component:
``AacLcDecoder::decode_access_unit`` (src/decoder.rs:104), bitreader,
section/scalefactor/pulse/TNS parsing, Huffman spectral decode
(src/spectral.rs), M/S + intensity stereo (decoder.rs:253-319), and
the 1024-sample LC constraint with explicit SBR/HE rejection
(decoder.rs:134-145).

Architecture split (TPU-first): this module is the HOST layer — ADTS
framing, bitstream parse, Huffman decode — producing fixed-shape
integer coefficient arrays + per-band metadata.  The numeric decode
(dequant, stereo tools, TNS, IMDCT, windowing, overlap-add) lives in
``soundkit_tpu.ops.aac_dsp`` and runs over ``[streams, ...]`` batches
on device.

Huffman codebooks are the ISO tables extracted from the system
libavcodec archive (native/generated/aac_tables.npz).
"""
from __future__ import annotations

import functools
from dataclasses import dataclass, field
from pathlib import Path
from typing import List, Optional, Tuple

import numpy as np

TABLES_PATH = Path(__file__).resolve().parent.parent / "data" / "aac_tables.npz"

ONLY_LONG_SEQUENCE = 0
LONG_START_SEQUENCE = 1
EIGHT_SHORT_SEQUENCE = 2
LONG_STOP_SEQUENCE = 3

ZERO_BT = 0
FIRST_PAIR_BT = 5
ESC_BT = 11
NOISE_BT = 13
INTENSITY_BT2 = 14
INTENSITY_BT = 15

SF_OFFSET = 100

SAMPLE_RATES = (96000, 88200, 64000, 48000, 44100, 32000, 24000, 22050,
                16000, 12000, 11025, 8000, 7350)


class AacError(ValueError):
    pass


@functools.lru_cache(maxsize=1)
def raw_tables() -> dict:
    """Every array of ``aac_tables.npz`` by name."""
    return dict(np.load(TABLES_PATH))


class BitReader:
    """MSB-first bit reader over bytes."""

    __slots__ = ("data", "pos", "nbits")

    def __init__(self, data: bytes):
        self.data = int.from_bytes(data, "big")
        self.nbits = len(data) * 8
        self.pos = 0

    def get(self, n: int) -> int:
        p = self.pos + n
        if p > self.nbits:
            raise AacError("bitstream overrun")
        v = (self.data >> (self.nbits - p)) & ((1 << n) - 1)
        self.pos = p
        return v

    def get1(self) -> int:
        return self.get(1)

    def peek(self, n: int) -> int:
        p = min(self.pos + n, self.nbits)
        got = p - self.pos
        v = (self.data >> (self.nbits - p)) & ((1 << got) - 1)
        return v << (n - got)

    def skip(self, n: int) -> None:
        self.pos += n
        if self.pos > self.nbits:
            raise AacError("bitstream overrun")

    @property
    def bits_left(self) -> int:
        return self.nbits - self.pos


# ---------------------------------------------------------------------------
# Huffman decode via canonical multi-level lookup
# ---------------------------------------------------------------------------

class Vlc:
    """Prefix-code decoder: (codes, bits) -> symbol index, built as a
    single dict keyed by (len, code) with a max-16-bit fast path."""

    def __init__(self, codes: np.ndarray, bits: np.ndarray):
        self.max_len = int(bits.max())
        self.table = {}
        # single flat LUT on max_len bits (max 19 for scalefactors)
        size = 1 << self.max_len
        self.lut_sym = np.full(size, -1, dtype=np.int32)
        self.lut_len = np.zeros(size, dtype=np.int8)
        for idx, (c, l) in enumerate(zip(codes.tolist(), bits.tolist())):
            shift = self.max_len - l
            base = c << shift
            self.lut_sym[base : base + (1 << shift)] = idx
            self.lut_len[base : base + (1 << shift)] = l

    def read(self, br: BitReader) -> int:
        window = br.peek(self.max_len)
        sym = int(self.lut_sym[window])
        if sym < 0:
            raise AacError("invalid Huffman code")
        br.skip(int(self.lut_len[window]))
        return sym


@functools.lru_cache(maxsize=1)
def _tables():
    t = np.load(TABLES_PATH)
    spectral = []
    for i in range(11):
        spectral.append(Vlc(t[f"spectral_codes_{i}"], t[f"spectral_bits_{i}"]))
    sf_vlc = Vlc(t["scalefactor_code"], t["scalefactor_bits"])
    swb_1024 = [t[f"swb_offset_1024_{i}"].astype(np.int32) for i in range(13)]
    swb_128 = [t[f"swb_offset_128_{i}"].astype(np.int32) for i in range(13)]
    return {
        "spectral": spectral,
        "sf": sf_vlc,
        "num_swb_1024": t["num_swb_1024"],
        "num_swb_128": t["num_swb_128"],
        "swb_1024": swb_1024,
        "swb_128": swb_128,
        "tns_max_1024": t["tns_max_bands_1024"],
        "tns_max_128": t["tns_max_bands_128"],
    }


# codebook properties: (dimension, label-av offset, signed)
_CB_INFO = {
    1: (4, 3, True), 2: (4, 3, True),        # base-3 signed quads (-1..1)
    3: (4, 3, False), 4: (4, 3, False),      # base-3 unsigned quads + signs
    5: (2, 9, True), 6: (2, 9, True),        # base-9 signed pairs (-4..4)
    7: (2, 8, False), 8: (2, 8, False),      # base-8 unsigned pairs + signs
    9: (2, 13, False), 10: (2, 13, False),   # base-13 unsigned pairs + signs
    11: (2, 17, False),                      # base-17, 16 = escape
}


def _unpack_index(cb: int, idx: int) -> List[int]:
    dim, base, signed = _CB_INFO[cb]
    vals = []
    for _ in range(dim):
        vals.append(idx % base)
        idx //= base
    vals.reverse()
    if signed:
        off = (base - 1) // 2
        vals = [v - off for v in vals]
    return vals


@dataclass
class TnsFilter:
    length: int
    order: int
    direction: int
    coefs: np.ndarray  # parcor reflection coefficients (float)


@dataclass
class IcsData:
    window_sequence: int = 0
    window_shape: int = 0
    max_sfb: int = 0
    num_windows: int = 1
    num_window_groups: int = 1
    group_lens: List[int] = field(default_factory=lambda: [1])
    band_type: np.ndarray = None  # [groups, max_sfb] int
    scale: np.ndarray = None  # [groups, max_sfb] float linear gain (2^((sf-100)/4))
    quant: np.ndarray = None  # [1024] int32, window-major layout
    tns: List[List[TnsFilter]] = field(default_factory=list)  # per window
    global_gain: int = 0
    num_swb: int = 0
    swb_offset: np.ndarray = None
    spectral_bit_start: int = -1  # AU-relative bit offset of
    # spectral_data (consumed by the device entropy decoder,
    # ops/aac_entropy.py)


@dataclass
class ChannelElement:
    kind: str  # "SCE" | "CPE" | "LFE"
    ics: List[IcsData]
    ms_mask: Optional[np.ndarray] = None  # [groups, max_sfb] bool


@dataclass
class AacFrame:
    elements: List[ChannelElement]
    sample_rate: int
    sample_rate_index: int


class AacLcDecoder:
    """ADTS / raw-AU parser. ``decode_au`` returns the parsed frame;
    numeric synthesis is ops.aac_dsp."""

    def __init__(self, sample_rate_index: Optional[int] = None):
        self.sr_index = sample_rate_index
        self.t = _tables()
        self.sbr_seen = False  # set when a FIL carries SBR data

    # -- ADTS --

    @staticmethod
    def parse_adts_header(data: bytes, pos: int) -> Tuple[int, int, int, int]:
        """Returns (frame_length, sr_index, channel_config, header_len)."""
        if len(data) - pos < 7:
            raise AacError("short ADTS header")
        b = data[pos : pos + 7]
        if b[0] != 0xFF or (b[1] & 0xF6) != 0xF0:
            raise AacError("bad ADTS sync")
        protection_absent = b[1] & 1
        profile = (b[2] >> 6) & 0x3
        if profile != 1:  # 1 = LC ("profile" is object type - 1)
            # HE-AAC signals LC at the ADTS layer; SBR is detected later
            pass
        sr_index = (b[2] >> 2) & 0xF
        chan_cfg = ((b[2] & 1) << 2) | (b[3] >> 6)
        frame_len = ((b[3] & 0x3) << 11) | (b[4] << 3) | (b[5] >> 5)
        header_len = 7 if protection_absent else 9
        return frame_len, sr_index, chan_cfg, header_len

    # -- raw data block --

    def decode_au(self, au: bytes) -> AacFrame:
        if self.sr_index is None:
            raise AacError("sample rate index not configured")
        br = BitReader(au)
        elements: List[ChannelElement] = []
        while br.bits_left >= 3:
            ide = br.get(3)
            if ide == 7:  # END
                break
            if ide == 0:  # SCE
                br.get(4)
                elements.append(ChannelElement("SCE", [self._decode_ics(br, False, None)]))
            elif ide == 1:  # CPE
                elements.append(self._decode_cpe(br))
            elif ide == 3:  # LFE
                br.get(4)
                elements.append(ChannelElement("LFE", [self._decode_ics(br, False, None)]))
            elif ide == 4:  # DSE
                self._skip_dse(br)
            elif ide == 5:  # PCE
                raise AacError("PCE not supported in raw AU path")
            elif ide == 6:  # FIL
                self._skip_fil(br)
            else:
                raise AacError(f"unsupported syntactic element {ide}")
        if not elements:
            raise AacError("empty access unit")
        return AacFrame(elements, SAMPLE_RATES[self.sr_index], self.sr_index)

    def _skip_dse(self, br: BitReader) -> None:
        br.get(4)
        align = br.get1()
        count = br.get(8)
        if count == 255:
            count += br.get(8)
        if align:
            br.skip((8 - br.pos % 8) % 8)
        br.skip(count * 8)

    def _skip_fil(self, br: BitReader) -> None:
        count = br.get(4)
        if count == 15:
            count += br.get(8) - 1
        # SBR extension payloads (type 13/14) mark an HE-AAC stream:
        # record the sighting so stream-level callers can reroute to a
        # full-machinery decoder (the reference rejects SBR explicitly,
        # decoder.rs:134-145); the LC path itself skips the payload
        if count > 0:
            ext = br.get(4)
            if ext in (13, 14):
                self.sbr_seen = True
            br.skip(count * 8 - 4)
        else:
            br.skip(count * 8)

    def _decode_cpe(self, br: BitReader) -> ChannelElement:
        br.get(4)
        common_window = br.get1()
        ms_mask = None
        shared_info = None
        if common_window:
            shared_info = self._decode_ics_info(br)
            ms_present = br.get(2)
            groups = shared_info["num_window_groups"]
            max_sfb = shared_info["max_sfb"]
            if ms_present == 1:
                ms_mask = np.zeros((groups, max_sfb), dtype=bool)
                for g in range(groups):
                    for s in range(max_sfb):
                        ms_mask[g, s] = bool(br.get1())
            elif ms_present == 2:
                ms_mask = np.ones((groups, max_sfb), dtype=bool)
            elif ms_present == 3:
                raise AacError("reserved ms_mask_present")
        ics0 = self._decode_ics(br, bool(common_window), shared_info)
        ics1 = self._decode_ics(br, bool(common_window), shared_info)
        return ChannelElement("CPE", [ics0, ics1], ms_mask)

    def _decode_ics_info(self, br: BitReader) -> dict:
        if br.get1():
            raise AacError("ics_reserved_bit set")
        window_sequence = br.get(2)
        window_shape = br.get1()
        if window_sequence == EIGHT_SHORT_SEQUENCE:
            max_sfb = br.get(4)
            grouping = br.get(7)
            group_lens = [1]
            for b in range(6, -1, -1):
                if (grouping >> b) & 1:
                    group_lens[-1] += 1
                else:
                    group_lens.append(1)
            num_swb = int(self.t["num_swb_128"][self.sr_index])
            swb_offset = self.t["swb_128"][self.sr_index]
            info = dict(
                window_sequence=window_sequence,
                window_shape=window_shape,
                max_sfb=max_sfb,
                num_windows=8,
                num_window_groups=len(group_lens),
                group_lens=group_lens,
                num_swb=num_swb,
                swb_offset=swb_offset,
            )
        else:
            max_sfb = br.get(6)
            predictor = br.get1()
            if predictor:
                raise AacError("predictor/LTP data not supported (LC only)")
            num_swb = int(self.t["num_swb_1024"][self.sr_index])
            swb_offset = self.t["swb_1024"][self.sr_index]
            info = dict(
                window_sequence=window_sequence,
                window_shape=window_shape,
                max_sfb=max_sfb,
                num_windows=1,
                num_window_groups=1,
                group_lens=[1],
                num_swb=num_swb,
                swb_offset=swb_offset,
            )
        if info["max_sfb"] > info["num_swb"]:
            raise AacError("max_sfb exceeds num_swb")
        return info

    def _decode_ics(self, br: BitReader, common_window: bool, shared_info) -> IcsData:
        ics = IcsData()
        ics.global_gain = br.get(8)
        info = shared_info if common_window else self._decode_ics_info(br)
        for k, v in info.items():
            setattr(ics, k, v)

        groups = ics.num_window_groups
        max_sfb = ics.max_sfb
        short = ics.window_sequence == EIGHT_SHORT_SEQUENCE

        # section_data
        band_type = np.zeros((groups, max(max_sfb, 1)), dtype=np.int32)
        bits = 3 if short else 5
        esc = (1 << bits) - 1
        for g in range(groups):
            k = 0
            while k < max_sfb:
                cb = br.get(4)
                if cb == 12:
                    raise AacError("invalid codebook 12")
                run = 0
                while True:
                    incr = br.get(bits)
                    run += incr
                    if incr != esc:
                        break
                if k + run > max_sfb:
                    raise AacError("section overruns max_sfb")
                band_type[g, k : k + run] = cb
                k += run
        ics.band_type = band_type

        # scale_factor_data
        sf_vlc = self.t["sf"]
        scale = np.zeros((groups, max(max_sfb, 1)), dtype=np.float64)
        sf = ics.global_gain
        is_pos = 0
        noise = ics.global_gain - 90
        noise_first = True
        for g in range(groups):
            for s in range(max_sfb):
                cb = band_type[g, s]
                if cb == ZERO_BT:
                    continue
                if cb in (INTENSITY_BT, INTENSITY_BT2):
                    is_pos += sf_vlc.read(br) - 60
                    scale[g, s] = 2.0 ** (-0.25 * is_pos)
                elif cb == NOISE_BT:
                    if noise_first:
                        noise += br.get(9) - 256
                        noise_first = False
                    else:
                        noise += sf_vlc.read(br) - 60
                    scale[g, s] = 2.0 ** (0.25 * (noise - SF_OFFSET))
                else:
                    sf += sf_vlc.read(br) - 60
                    if not 0 <= sf <= 255:
                        raise AacError("scalefactor out of range")
                    scale[g, s] = 2.0 ** (0.25 * (sf - SF_OFFSET))
        ics.scale = scale

        # pulse
        pulses = None
        if br.get1():
            if short:
                raise AacError("pulse data in short window")
            n_pulse = br.get(2) + 1
            start_sfb = br.get(6)
            if start_sfb >= ics.num_swb:
                raise AacError("pulse start out of range")
            base = int(ics.swb_offset[start_sfb])
            pulses = []
            pos = base
            for _ in range(n_pulse):
                pos += br.get(5)
                amp = br.get(4)
                pulses.append((pos, amp))

        # tns
        ics.tns = [[] for _ in range(ics.num_windows)]
        if br.get1():
            for w in range(ics.num_windows):
                n_filt = br.get(1 if short else 2)
                coef_res = br.get1() if n_filt else 0
                for _ in range(n_filt):
                    length = br.get(4 if short else 6)
                    order = br.get(3 if short else 5)
                    if order:
                        direction = br.get1()
                        compress = br.get1()
                        coef_len = coef_res + 3 - compress
                        crb = coef_res + 3
                        iqfac = ((1 << (crb - 1)) - 0.5) / (np.pi / 2.0)
                        iqfac_m = ((1 << (crb - 1)) + 0.5) / (np.pi / 2.0)
                        coefs = np.zeros(order)
                        for i in range(order):
                            c = br.get(coef_len)
                            if c >= 1 << (coef_len - 1):
                                c -= 1 << coef_len
                            coefs[i] = np.sin(c / (iqfac if c >= 0 else iqfac_m))
                        ics.tns[w].append(TnsFilter(length, order, direction, coefs))
                    else:
                        ics.tns[w].append(TnsFilter(length, 0, 0, np.zeros(0)))

        if br.get1():
            raise AacError("gain control (SSR) not supported")

        # spectral_data
        ics.spectral_bit_start = br.pos
        quant = np.zeros(1024, dtype=np.int32)
        win_base = []
        acc = 0
        for g in range(groups):
            win_base.append(acc)
            acc += ics.group_lens[g]
        spectral = self.t["spectral"]
        for g in range(groups):
            glen = ics.group_lens[g]
            for s in range(max_sfb):
                cb = band_type[g, s]
                if cb == ZERO_BT or cb >= NOISE_BT:
                    continue
                lo = int(ics.swb_offset[s])
                hi = int(ics.swb_offset[s + 1])
                vlc = spectral[cb - 1]
                dim, base, signed = _CB_INFO[cb]
                for w in range(glen):
                    wabs = win_base[g] + w
                    off = wabs * 128 if short else 0
                    k = lo
                    while k < hi:
                        idx = vlc.read(br)
                        vals = _unpack_index(cb, idx)
                        if not signed:
                            for i, v in enumerate(vals):
                                if v != 0 and br.get1():
                                    vals[i] = -v
                        if cb == ESC_BT:
                            for i, v in enumerate(vals):
                                if abs(v) == 16:
                                    n = 4
                                    while br.get1():
                                        n += 1
                                        if n > 28:
                                            raise AacError("escape overflow")
                                    mag = (1 << n) | br.get(n)
                                    vals[i] = mag if v > 0 else -mag
                        for i, v in enumerate(vals):
                            quant[off + k + i] = v
                        k += dim
        if pulses is not None:
            for pos, amp in pulses:
                if pos >= 1024:
                    raise AacError("pulse position out of range")
                if quant[pos] > 0:
                    quant[pos] += amp
                else:
                    quant[pos] -= amp
        ics.quant = quant
        return ics


class AdtsStream:
    """Incremental ADTS framer: bytes in, raw AUs (headers stripped)
    out. The first frame fixes ``sr_index`` and ``channel_config``. It
    builds no ``AacLcDecoder``: the streaming ``codecs.aac.AacDecoder``
    owns its own, and the batched path's framers load no VLC tables."""

    def __init__(self) -> None:
        self._buf = bytearray()
        self.sr_index: Optional[int] = None
        self.channel_config: Optional[int] = None

    def push(self, data: bytes) -> List[bytes]:
        """Returns raw AUs (ADTS headers stripped)."""
        self._buf.extend(data)
        aus = []
        while True:
            # resync
            i = 0
            while i + 1 < len(self._buf) and not (
                self._buf[i] == 0xFF and (self._buf[i + 1] & 0xF6) == 0xF0
            ):
                i += 1
            if i:
                del self._buf[:i]
            if len(self._buf) < 7:
                break
            try:
                frame_len, sr_idx, chan, hdr = AacLcDecoder.parse_adts_header(
                    bytes(self._buf), 0
                )
            except AacError:
                del self._buf[:1]
                continue
            if frame_len < hdr:
                del self._buf[:1]
                continue
            if len(self._buf) < frame_len:
                break
            if self.sr_index is None:
                self.sr_index = sr_idx
                self.channel_config = chan
            aus.append(bytes(self._buf[hdr:frame_len]))
            del self._buf[:frame_len]
        return aus
