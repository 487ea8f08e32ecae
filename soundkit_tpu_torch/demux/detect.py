"""Audio container/codec detection by magic bytes and syncwords.

Behavioral equivalent of the ``access-unit`` crate's ``detect_audio``
as used by the reference pipeline (soundkit-decoder/src/lib.rs:
1043-1113): variants MP3, AAC, M4A, FLAC, Opus, OggOpus, OggVorbis,
OggSpeex, WebM, Wav, ALAC, AIFF, AC3, Unknown.  Telephony formats
(G.711/722/726/729, GSM, AMR, raw PCM) are explicit-only paths, never
autodetected — same as the reference.
"""
from __future__ import annotations

import enum


class AudioType(enum.Enum):
    MP3 = "mp3"
    AAC = "aac"  # raw ADTS
    M4A = "m4a"
    FLAC = "flac"
    OPUS = "opus"  # soundkit raw-Opus framing (OpusHead + length-prefixed)
    OGG_OPUS = "ogg_opus"
    OGG_VORBIS = "ogg_vorbis"
    OGG_SPEEX = "ogg_speex"
    WEBM = "webm"
    WAV = "wav"
    ALAC = "alac"
    AIFF = "aiff"
    AC3 = "ac3"
    UNKNOWN = "unknown"


MIN_DETECTION_BYTES = 8192  # soundkit-decoder/src/lib.rs:49
MAX_DETECTION_BYTES = 65536  # :50

_MPEG1_L3_BITRATES = (0, 32, 40, 48, 56, 64, 80, 96, 112, 128, 160, 192, 224, 256, 320, 0)
_MPEG2_L3_BITRATES = (0, 8, 16, 24, 32, 40, 48, 56, 64, 80, 96, 112, 128, 144, 160, 0)


_MP3_RATES = {0: (11025, 12000, 8000), 2: (22050, 24000, 16000), 3: (44100, 48000, 32000)}


def _mp3_header_ok(b: bytes, i: int) -> int:
    """Valid Layer III header at i -> frame byte length, else 0."""
    if i + 4 > len(b):
        return 0
    if b[i] != 0xFF or (b[i + 1] & 0xE0) != 0xE0:
        return 0
    version = (b[i + 1] >> 3) & 0x3  # 0=2.5, 2=2, 3=1
    layer = (b[i + 1] >> 1) & 0x3  # 1 = Layer III
    if version == 1 or layer != 1:
        return 0
    bitrate_idx = (b[i + 2] >> 4) & 0xF
    rate_idx = (b[i + 2] >> 2) & 0x3
    if bitrate_idx in (0, 15) or rate_idx == 3:
        return 0
    table = _MPEG1_L3_BITRATES if version == 3 else _MPEG2_L3_BITRATES
    kbps = table[bitrate_idx]
    rate = _MP3_RATES[version][rate_idx]
    padding = (b[i + 2] >> 1) & 1
    spf = 1152 if version == 3 else 576
    return spf // 8 * kbps * 1000 // rate + padding


def _looks_like_mp3_frame(b: bytes, i: int) -> bool:
    """Header + next-frame chaining (a lone 11-bit sync pattern appears
    in arbitrary payloads; requiring the next sync at the computed
    frame boundary removes the false positives)."""
    n = _mp3_header_ok(b, i)
    if not n:
        return False
    j = i + n
    if j + 4 > len(b):
        # no room for a second header: accept only a complete first
        # frame (a frame length pointing past EOF is a payload byte
        # pattern, not a stream — e.g. raw AMR data reading as sync)
        return j <= len(b)
    return _mp3_header_ok(b, j) > 0


def _adts_header_ok(b: bytes, i: int) -> int:
    """Valid ADTS header at i -> frame byte length, else 0."""
    if i + 7 > len(b):
        return 0
    if b[i] != 0xFF or (b[i + 1] & 0xF6) != 0xF0:
        return 0
    sf_index = (b[i + 2] >> 2) & 0xF
    if sf_index >= 13:
        return 0
    length = ((b[i + 3] & 0x3) << 11) | (b[i + 4] << 3) | (b[i + 5] >> 5)
    return length if length >= 7 else 0


def _looks_like_adts(b: bytes, i: int) -> bool:
    """ADTS header + frame-length chaining to the next syncword (same
    sampling-frequency index), rejecting lone sync-pattern bytes."""
    n = _adts_header_ok(b, i)
    if not n:
        return False
    j = i + n
    if j + 7 > len(b):
        # no room for a second header: accept only a complete first
        # frame (see _looks_like_mp3_frame)
        return j <= len(b)
    if not _adts_header_ok(b, j):
        return False
    return ((b[i + 2] >> 2) & 0xF) == ((b[j + 2] >> 2) & 0xF)


def looks_like_ac3(b: bytes) -> bool:
    """0x0B77 syncword probe (soundkit-ac3/src/lib.rs:22)."""
    return len(b) >= 2 and b[0] == 0x0B and b[1] == 0x77


def detect_audio(buffer: bytes) -> AudioType:
    b = bytes(buffer[:MAX_DETECTION_BYTES])
    if len(b) < 4:
        return AudioType.UNKNOWN

    if b[:4] == b"RIFF" and len(b) >= 12 and b[8:12] == b"WAVE":
        return AudioType.WAV
    if b[:4] == b"fLaC":
        return AudioType.FLAC
    if b[:4] == b"OggS":
        # first page payload begins at 27 + n_segments
        if len(b) >= 28:
            nseg = b[26]
            payload = b[27 + nseg : 27 + nseg + 8]
            if payload.startswith(b"OpusHead"):
                return AudioType.OGG_OPUS
            if payload.startswith(b"\x01vorbis"):
                return AudioType.OGG_VORBIS
            if payload.startswith(b"Speex   "):
                return AudioType.OGG_SPEEX
        return AudioType.UNKNOWN
    if b[:4] == b"\x1a\x45\xdf\xa3":
        return AudioType.WEBM
    if b[:4] == b"FORM" and len(b) >= 12 and b[8:12] in (b"AIFF", b"AIFC"):
        return AudioType.AIFF
    if len(b) >= 12 and b[4:8] == b"ftyp":
        # M4A container; ALAC if an alac sample entry appears
        return AudioType.ALAC if b"alac" in b else AudioType.M4A
    if b[:8] == b"OpusHead":
        return AudioType.OPUS
    if looks_like_ac3(b):
        return AudioType.AC3
    if b[:3] == b"ID3":
        return AudioType.MP3
    if _looks_like_adts(b, 0):
        return AudioType.AAC
    if _looks_like_mp3_frame(b, 0):
        return AudioType.MP3
    # scan a short window for an MP3/ADTS sync preceded by junk
    for i in range(min(len(b) - 4, 4096)):
        if b[i] == 0xFF:
            if _looks_like_adts(b, i):
                return AudioType.AAC
            if _looks_like_mp3_frame(b, i):
                return AudioType.MP3
    return AudioType.UNKNOWN
