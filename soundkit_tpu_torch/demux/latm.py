"""LOAS/LATM (ISO/IEC 14496-3 §1.7) demuxer and muxer.

The reference tags MPEG-TS stream_type 0x11 packets as LATM and
passes the PES payload through unparsed
(soundkit-audio-demux/src/lib.rs:2249,2369).  We go further: this
module parses the LOAS AudioSyncStream / LATM AudioMuxElement layers
down to raw AAC access units plus an AudioSpecificConfig, so LATM
transport streams decode end-to-end.  A writer (``mux_loas``) is
included so fixtures can be synthesized without ffmpeg and so the
encode side can emit broadcast-style LOAS.

Supported profile (the broadcast common case): audioMuxVersion 0 or 1,
audioMuxVersionA 0, one program / one layer, allStreamsSameTimeFraming,
frameLengthType 0 (variable payload length with 255-escape chunks).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

LOAS_SYNC = 0x2B7  # 11-bit syncword of AudioSyncStream

SAMPLE_RATES = (
    96000, 88200, 64000, 48000, 44100, 32000,
    24000, 22050, 16000, 12000, 11025, 8000, 7350,
)


class LatmError(ValueError):
    pass


class _BitReader:
    """MSB-first bit reader (local to keep LATM dependency-free)."""

    __slots__ = ("data", "nbits", "pos")

    def __init__(self, data: bytes):
        self.data = int.from_bytes(data, "big")
        self.nbits = len(data) * 8
        self.pos = 0

    def get(self, n: int) -> int:
        p = self.pos + n
        if p > self.nbits:
            raise LatmError("LATM bitstream overrun")
        v = (self.data >> (self.nbits - p)) & ((1 << n) - 1)
        self.pos = p
        return v

    def get_bytes(self, n: int) -> bytes:
        """Read n bytes as a bit-packed run (not necessarily aligned)."""
        if n == 0:
            return b""
        return self.get(8 * n).to_bytes(n, "big")

    @property
    def bits_left(self) -> int:
        return self.nbits - self.pos


class _BitWriter:
    __slots__ = ("acc", "nbits")

    def __init__(self) -> None:
        self.acc = 0
        self.nbits = 0

    def put(self, value: int, n: int) -> None:
        self.acc = (self.acc << n) | (value & ((1 << n) - 1))
        self.nbits += n

    def put_bytes(self, data: bytes) -> None:
        for b in data:
            self.put(b, 8)

    def bytes_aligned(self) -> bytes:
        pad = (-self.nbits) % 8
        acc = self.acc << pad
        return acc.to_bytes((self.nbits + pad) // 8, "big")


# ---------------------------------------------------------------------------
# AudioSpecificConfig
# ---------------------------------------------------------------------------

@dataclass
class AscInfo:
    """Parsed AudioSpecificConfig (ISO 14496-3 Table 1.15)."""

    object_type: int
    sr_index: int
    sample_rate: int
    channel_config: int
    frame_length_flag: int = 0

    @property
    def channels(self) -> int:
        # channelConfiguration 7 means 7.1 (8 ch); 0 means PCE-defined
        return 8 if self.channel_config == 7 else self.channel_config

    def to_bytes(self) -> bytes:
        """Canonical re-serialization (GA object types)."""
        w = _BitWriter()
        if self.object_type < 31:
            w.put(self.object_type, 5)
        else:
            w.put(31, 5)
            w.put(self.object_type - 32, 6)
        if self.sr_index == 0xF:
            w.put(0xF, 4)
            w.put(self.sample_rate, 24)
        else:
            w.put(self.sr_index, 4)
        w.put(self.channel_config, 4)
        # GASpecificConfig: frameLengthFlag, dependsOnCoreCoder, extensionFlag
        w.put(self.frame_length_flag, 1)
        w.put(0, 1)
        w.put(0, 1)
        return w.bytes_aligned()


def _parse_asc_bits(br: _BitReader) -> AscInfo:
    """Parse an inline AudioSpecificConfig, consuming exactly its bits.

    Handles the GA object types (1 AAC Main, 2 AAC-LC, 3 SSR, 4 LTP,
    6 Scalable, 7 TwinVQ, 17/19/20/21/22/23 ER) which is what LATM
    broadcast streams carry; anything else raises LatmError.
    """
    object_type = br.get(5)
    if object_type == 31:
        object_type = 32 + br.get(6)
    sr_index = br.get(4)
    if sr_index == 0xF:
        sample_rate = br.get(24)
    else:
        if sr_index >= len(SAMPLE_RATES):
            raise LatmError(f"reserved sampling frequency index {sr_index}")
        sample_rate = SAMPLE_RATES[sr_index]
    channel_config = br.get(4)

    ga_types = {1, 2, 3, 4, 6, 7, 17, 19, 20, 21, 22, 23}
    if object_type == 5 or object_type == 29:
        # explicit SBR/PS signalling: extension sr index then the
        # underlying object type
        ext_sr = br.get(4)
        if ext_sr == 0xF:
            sample_rate = br.get(24)
        else:
            sample_rate = SAMPLE_RATES[ext_sr] if ext_sr < len(SAMPLE_RATES) else sample_rate
        object_type = br.get(5)
        if object_type == 31:
            object_type = 32 + br.get(6)
    if object_type not in ga_types:
        raise LatmError(f"unsupported LATM audio object type {object_type}")

    # GASpecificConfig (Table 4.1)
    frame_length_flag = br.get(1)
    depends_on_core = br.get(1)
    if depends_on_core:
        br.get(14)  # coreCoderDelay
    extension_flag = br.get(1)
    if channel_config == 0:
        raise LatmError("LATM PCE-configured channel layout unsupported")
    if object_type in (6, 20):
        br.get(3)  # layerNr
    if extension_flag:
        if object_type == 22:
            br.get(5 + 11)  # numOfSubFrame + layer_length
        if object_type in (17, 19, 20, 23):
            br.get(3)  # aacSectionDataResilienceFlag etc.
        ext2 = br.get(1)
        if ext2:
            raise LatmError("extensionFlag3 unsupported")
    return AscInfo(object_type, sr_index, sample_rate, channel_config,
                   frame_length_flag)


def parse_audio_specific_config(data: bytes) -> AscInfo:
    """Parse a byte-aligned AudioSpecificConfig (e.g. from esds)."""
    return _parse_asc_bits(_BitReader(data))


# ---------------------------------------------------------------------------
# StreamMuxConfig / AudioMuxElement
# ---------------------------------------------------------------------------

@dataclass
class StreamMuxConfig:
    asc: AscInfo
    audio_mux_version: int = 0
    num_subframes: int = 1  # numSubFrames + 1
    frame_length_type: int = 0
    frame_length: int = 0  # frameLengthType 1: payload bytes
    other_data_bits: int = 0
    crc_present: bool = False


def _latm_get_value(br: _BitReader) -> int:
    n = br.get(2) + 1
    v = 0
    for _ in range(n):
        v = (v << 8) | br.get(8)
    return v


def parse_stream_mux_config(br: _BitReader) -> StreamMuxConfig:
    version = br.get(1)
    if version == 1 and br.get(1):  # audioMuxVersionA
        raise LatmError("audioMuxVersionA != 0 unsupported")
    if version == 1:
        _latm_get_value(br)  # taraBufferFullness
    all_same_timing = br.get(1)
    num_subframes = br.get(6) + 1
    num_program = br.get(4)
    if num_program != 0:
        raise LatmError("multi-program LATM unsupported")
    num_layer = br.get(3)
    if num_layer != 0:
        raise LatmError("multi-layer LATM unsupported")
    if not all_same_timing:
        raise LatmError("allStreamsSameTimeFraming==0 unsupported")
    if version == 0:
        asc = _parse_asc_bits(br)
    else:
        asc_len = _latm_get_value(br)
        start = br.pos
        asc = _parse_asc_bits(br)
        used = br.pos - start
        if used > asc_len:
            raise LatmError("ASC overran its declared length")
        br.get(asc_len - used)  # fillBits
    flt = br.get(3)
    cfg = StreamMuxConfig(asc, version, num_subframes, flt)
    if flt == 0:
        br.get(8)  # latmBufferFullness
    elif flt == 1:
        cfg.frame_length = br.get(9)
    else:
        raise LatmError(f"frameLengthType {flt} unsupported")
    if br.get(1):  # otherDataPresent
        if version == 1:
            cfg.other_data_bits = _latm_get_value(br)
        else:
            bits = 0
            while True:
                esc = br.get(1)
                bits = (bits << 8) | br.get(8)
                if not esc:
                    break
            cfg.other_data_bits = bits
    if br.get(1):  # crcCheckPresent
        cfg.crc_present = True
        br.get(8)
    return cfg


def parse_audio_mux_element(
    data: bytes,
    prev_config: Optional[StreamMuxConfig] = None,
    mux_config_present: bool = True,
) -> Tuple[StreamMuxConfig, List[bytes]]:
    """Parse one AudioMuxElement -> (config, access units).

    ``prev_config`` supplies the StreamMuxConfig when the element sets
    useSameStreamMux (or when muxConfigPresent is 0, the out-of-band
    config case).
    """
    br = _BitReader(data)
    cfg = prev_config
    if mux_config_present:
        use_same = br.get(1)
        if not use_same:
            cfg = parse_stream_mux_config(br)
    if cfg is None:
        raise LatmError("LATM payload before any StreamMuxConfig")
    aus: List[bytes] = []
    for _ in range(cfg.num_subframes):
        if cfg.frame_length_type == 0:
            n = 0
            while True:
                tmp = br.get(8)
                n += tmp
                if tmp != 255:
                    break
        else:
            n = cfg.frame_length
        aus.append(br.get_bytes(n))
    if cfg.other_data_bits:
        br.get(cfg.other_data_bits)
    return cfg, aus


# ---------------------------------------------------------------------------
# LOAS AudioSyncStream
# ---------------------------------------------------------------------------

class LoasDemuxer:
    """Incremental LOAS (AudioSyncStream) parser.

    push() accepts arbitrary chunks and returns raw access units;
    ``config`` holds the most recent StreamMuxConfig (None until the
    first in-band config arrives).  Bad bytes between frames are
    skipped by resyncing on the 11-bit 0x2B7 syncword.
    """

    def __init__(self) -> None:
        self._buf = bytearray()
        self.config: Optional[StreamMuxConfig] = None
        self.frames = 0

    def push(self, data: bytes) -> List[bytes]:
        self._buf.extend(data)
        out: List[bytes] = []
        while True:
            i = self._find_sync()
            if i is None:
                break
            if i:
                del self._buf[:i]
            n = ((self._buf[1] & 0x1F) << 8) | self._buf[2]
            if len(self._buf) < 3 + n:
                break
            payload = bytes(self._buf[3 : 3 + n])
            try:
                cfg, aus = parse_audio_mux_element(payload, self.config)
            except LatmError:
                # false sync (or corrupt element): resume the scan one
                # byte in so a real syncword inside the claimed span
                # isn't skipped
                del self._buf[:1]
                continue
            del self._buf[: 3 + n]
            self.config = cfg
            self.frames += 1
            out.extend(aus)
        return out

    def flush(self) -> List[bytes]:
        return []

    def _find_sync(self) -> Optional[int]:
        b = self._buf
        for i in range(len(b) - 2):
            if b[i] == 0x56 and (b[i + 1] & 0xE0) == 0xE0:
                return i
        # keep at most the last two bytes (a split syncword candidate)
        if len(b) > 2:
            del b[: len(b) - 2]
        return None


def looks_like_loas(b: bytes) -> bool:
    """Two length-chained LOAS sync frames => LOAS stream."""
    if len(b) < 3 or b[0] != 0x56 or (b[1] & 0xE0) != 0xE0:
        return False
    n = ((b[1] & 0x1F) << 8) | b[2]
    if n == 0:
        return False
    j = 3 + n
    if j + 3 > len(b):
        return j <= len(b)
    return b[j] == 0x56 and (b[j + 1] & 0xE0) == 0xE0


# ---------------------------------------------------------------------------
# Writer
# ---------------------------------------------------------------------------

def write_stream_mux_config(w: _BitWriter, asc: AscInfo) -> None:
    w.put(0, 1)  # audioMuxVersion 0
    w.put(1, 1)  # allStreamsSameTimeFraming
    w.put(0, 6)  # numSubFrames = 0 (one subframe)
    w.put(0, 4)  # numProgram
    w.put(0, 3)  # numLayer
    # inline ASC (version 0)
    if asc.object_type < 31:
        w.put(asc.object_type, 5)
    else:
        w.put(31, 5)
        w.put(asc.object_type - 32, 6)
    w.put(asc.sr_index, 4)
    if asc.sr_index == 0xF:
        w.put(asc.sample_rate, 24)
    w.put(asc.channel_config, 4)
    w.put(asc.frame_length_flag, 1)  # GASpecificConfig
    w.put(0, 1)
    w.put(0, 1)
    w.put(0, 3)  # frameLengthType 0
    w.put(0xFF, 8)  # latmBufferFullness: unspecified
    w.put(0, 1)  # otherDataPresent
    w.put(0, 1)  # crcCheckPresent


def write_audio_mux_element(au: bytes, asc: AscInfo, include_config: bool) -> bytes:
    w = _BitWriter()
    if include_config:
        w.put(0, 1)  # useSameStreamMux = 0
        write_stream_mux_config(w, asc)
    else:
        w.put(1, 1)
    n = len(au)
    while n >= 255:
        w.put(255, 8)
        n -= 255
    w.put(n, 8)
    w.put_bytes(au)
    return w.bytes_aligned()


def mux_loas(aus: List[bytes], asc: AscInfo, config_period: int = 8) -> bytes:
    """Wrap raw AAC access units as a LOAS AudioSyncStream; the
    StreamMuxConfig is repeated every ``config_period`` frames (first
    frame always carries it)."""
    out = bytearray()
    for i, au in enumerate(aus):
        payload = write_audio_mux_element(
            au, asc, include_config=(i % config_period == 0)
        )
        if len(payload) >= 1 << 13:
            raise LatmError("AudioMuxElement exceeds the 13-bit LOAS length")
        out.append(0x56)
        out.append(0xE0 | (len(payload) >> 8))
        out.append(len(payload) & 0xFF)
        out.extend(payload)
    return bytes(out)
