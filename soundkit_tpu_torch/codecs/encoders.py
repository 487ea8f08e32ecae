"""Encoders: AAC (ADTS), FLAC, MP3, Opus, plus the generic
``AudioEncoder`` packet pipeline.

API equivalents of the reference encode side:
- ``AacEncoder`` (soundkit-aac/src/lib.rs:20-100): ADTS output.
- ``FlacEncoder`` (soundkit-flac/src/lib.rs:35): raw FLAC frame
  packets (the independently-framed stream of frame_codec.rs — the
  same shape as the golden/flac fixtures).
- ``Mp3Encoder`` (soundkit-mp3, lame-backed), ``OpusEncoder``
  (soundkit-opus).
- ``AudioEncoder`` (soundkit/src/audio_pipeline.rs:209-334): WAV bytes
  in -> per-frame encoded packets with v1 headers, widow-chunk carry,
  and the [count:u32][offsets:u32...][packets] flush container.

Port: the libavcodec encoder ``AvEncoder`` raises ``EncodeError`` at
construction (the port builds no libavcodec), and with it ``AacEncoder``,
``Mp3Encoder`` and ``OpusEncoder``'s libopus route (another rate than
48 kHz, or ``backend="libopus"``). The owned encoders (``FlacEncoder``,
``OpusEncoder``'s CELT, SILK and hybrid routes) and ``AudioEncoder`` are
the JAX package's code.
"""
from __future__ import annotations

import struct
from typing import List, Optional

import numpy as np

from soundkit_tpu_torch.core import audio_bytes as ab
from soundkit_tpu_torch.core.audio_types import AudioData, EncodingFlag, Endianness
from soundkit_tpu_torch.core.frame_header import FrameHeader
from soundkit_tpu_torch.core.wav import WavStreamProcessor

ADTS_SAMPLE_RATES = (96000, 88200, 64000, 48000, 44100, 32000, 24000, 22050,
                     16000, 12000, 11025, 8000, 7350)


class EncodeError(ValueError):
    pass


class AvEncoder:
    """The JAX package's generic libavcodec encoder; the port builds no
    libavcodec, so a codec that needs it raises here."""

    def __init__(self, codec_name: str, sample_rate: int, channels: int, bit_rate: int = 0):
        raise EncodeError(f"encoder {codec_name!r} encodes only through libavcodec, "
                          "which the port does not build")


def adts_header(payload_len: int, sr_index: int, channel_config: int, profile: int = 1) -> bytes:
    """7-byte ADTS header (protection absent)."""
    frame_len = payload_len + 7
    b = bytearray(7)
    b[0] = 0xFF
    b[1] = 0xF1
    b[2] = ((profile & 3) << 6) | ((sr_index & 0xF) << 2) | ((channel_config >> 2) & 1)
    b[3] = ((channel_config & 3) << 6) | ((frame_len >> 11) & 0x3)
    b[4] = (frame_len >> 3) & 0xFF
    b[5] = ((frame_len & 0x7) << 5) | 0x1F
    b[6] = 0xFC
    return bytes(b)


class AacEncoder:
    """ADTS VBR-ish AAC encoder (reference: FDK ADTS transport)."""

    def __init__(self, sample_rate: int, channels: int, bit_rate: int = 0):
        if sample_rate not in ADTS_SAMPLE_RATES:
            raise EncodeError(f"unsupported AAC sample rate {sample_rate}")
        self._enc = AvEncoder("aac", sample_rate, channels, bit_rate)
        self._sr_index = ADTS_SAMPLE_RATES.index(sample_rate)
        self._channels = channels
        self.frame_size = self._enc.frame_size

    def _mux(self, packets: List[bytes]) -> bytes:
        return b"".join(
            adts_header(len(p), self._sr_index, self._channels) + p for p in packets
        )

    def encode_i16(self, samples: np.ndarray) -> bytes:
        return self._mux(self._enc.push_i16(samples))

    def encode_f32(self, interleaved: np.ndarray) -> bytes:
        return self._mux(self._enc.push_f32(interleaved))

    def flush(self) -> bytes:
        return self._mux(self._enc.flush())


class FlacEncoder:
    """Raw-frame FLAC encoder (independently decodable frame packets).

    OWNED: codecs/flac_encode.py (fixed + LPC subframes, Rice/Rice2,
    stereo decorrelation) — the avcodec delegate is gone, matching the
    reference's pure frame encoder (soundkit-flac/src/frame_codec.rs:
    42-278).  Each ``encode_*`` call emits complete frames for the
    samples it can block; a sub-minimum tail is held for ``flush``.
    """

    def __init__(self, sample_rate: int, bits_per_sample: int, channels: int,
                 frame_size: int = 0, compression_level: int = 5):
        from soundkit_tpu_torch.codecs.flac_encode import BitWriter, FlacFrameEncoder

        profile = ("realtime" if compression_level <= 2
                   else "balanced" if compression_level <= 5 else "maximum")
        self._enc = FlacFrameEncoder(sample_rate, channels,
                                     bits_per_sample, profile)
        self.bits_per_sample = bits_per_sample
        self.channels = channels
        self.frame_size = frame_size or 4096
        self._tail = np.zeros((channels, 0), np.int64)
        self._BitWriter = BitWriter

    def _encode_chans(self, chans: np.ndarray) -> bytes:
        chans = np.concatenate([self._tail, chans], axis=1)
        self._tail = chans[:, :0]
        out = []
        off = 0
        n = chans.shape[1]
        while n - off >= self.frame_size:
            out.append(self._enc.encode_frame(chans[:, off : off + self.frame_size]))
            off += self.frame_size
        rest = n - off
        if rest >= 16:
            out.append(self._enc.encode_frame(chans[:, off:]))
        elif rest:
            self._tail = chans[:, off:]
        return b"".join(out)

    def encode_i32(self, samples: np.ndarray) -> bytes:
        """Interleaved ints in the declared bit depth's range."""
        x = np.asarray(samples, np.int64).reshape(-1, self.channels).T
        return self._encode_chans(x)

    def encode_i16(self, samples: np.ndarray) -> bytes:
        x = np.asarray(samples, np.int64).reshape(-1, self.channels).T
        if self.bits_per_sample == 24:
            x = x << 8
        return self._encode_chans(x)

    def flush(self) -> bytes:
        if self._tail.shape[1] == 0:
            return b""
        # pad the sub-minimum tail with the held last value to the
        # 16-sample frame minimum
        pad = 16 - self._tail.shape[1]
        tail = np.concatenate(
            [self._tail, np.repeat(self._tail[:, -1:], pad, axis=1)], axis=1
        )
        self._tail = self._tail[:, :0]
        return self._enc.encode_frame(tail)

    @property
    def streaminfo(self) -> bytes:
        """34-byte STREAMINFO for the track contract (frame sizes and
        MD5 zero = unknown, valid per spec for a live frame stream)."""
        w = self._BitWriter()
        w.write(self.frame_size, 16)
        w.write(self.frame_size, 16)
        w.write(0, 24)
        w.write(0, 24)
        w.write(self._enc.sample_rate, 20)
        w.write(self.channels - 1, 3)
        w.write(self.bits_per_sample - 1, 5)
        w.write(0, 36)
        for _ in range(16):
            w.write(0, 8)
        return w.bytes()


class Mp3Encoder:
    def __init__(self, sample_rate: int, channels: int, bit_rate: int = 128000):
        self._enc = AvEncoder("libmp3lame", sample_rate, channels, bit_rate)
        self.frame_size = self._enc.frame_size

    def encode_i16(self, samples: np.ndarray) -> bytes:
        return b"".join(self._enc.push_i16(samples))

    def flush(self) -> bytes:
        return b"".join(self._enc.flush())


class OpusEncoder:
    """Opus packet encoder.

    The default backend at 48 kHz is the OWNED RFC 6716 CELT-mode
    encoder (``opus_celt_enc.py``) — encode-math parity with the
    reference's pure-Rust path (soundkit-opus/src/lib.rs:96-293,
    Cargo.toml:11-14).  Packets are CELT fullband CBR and decode on
    any conformant decoder with zero codec delay (pre_skip=0).
    ``mode="voice"`` selects the owned SILK-layer encoder instead
    (``opus_silk_enc.py``): NB/MB/WB VBR speech packets, mono or
    stereo; ``voice_bandwidth="swb"/"fb"`` selects the owned HYBRID
    mode (``opus_hybrid_enc.py``, SILK-WB low band + CELT band-17+
    high band on one coder, CBR).
    Other sample rates, and ``backend="libopus"``, use the libopus
    shim (pre_skip=312, the shim's reported lookahead).
    """

    def __init__(self, sample_rate: int = 48000, channels: int = 2,
                 bit_rate: int = 64000, backend: str = "owned",
                 mode: str = "music", voice_bandwidth: str = "wb"):
        self.sample_rate = sample_rate
        self.channels = channels
        if (backend == "owned" and sample_rate == 48000
                and mode == "voice" and channels in (1, 2)
                and voice_bandwidth in ("swb", "fb")):
            from soundkit_tpu_torch.codecs.opus_hybrid_enc import (
                OpusHybridEncoder,
            )

            self._own: Optional[object] = OpusHybridEncoder(
                bandwidth=voice_bandwidth, bit_rate=bit_rate,
                channels=channels,
            )
            self._enc = None
            self.frame_size = self._own.frame_size
            self.pre_skip = 0
            self.backend = "owned-hybrid"
        elif (backend == "owned" and sample_rate == 48000
                and mode == "voice" and channels in (1, 2)):
            from soundkit_tpu_torch.codecs.opus_silk_enc import OpusSilkEncoder

            self._own: Optional[object] = OpusSilkEncoder(
                bandwidth=voice_bandwidth, bit_rate=bit_rate,
                channels=channels,
            )
            self._enc = None
            self.frame_size = self._own.frame_size
            self.pre_skip = 0
            self.backend = "owned-silk"
        elif backend == "owned" and sample_rate == 48000 and channels in (1, 2):
            from soundkit_tpu_torch.codecs.opus_celt_enc import OpusCeltEncoder

            self._own: Optional[object] = OpusCeltEncoder(
                channels=channels, bit_rate=bit_rate
            )
            self._enc = None
            self.frame_size = self._own.frame_size
            self.pre_skip = 0
            self.backend = "owned"
        else:
            self._own = None
            self._enc = AvEncoder("libopus", sample_rate, channels, bit_rate)
            self.frame_size = self._enc.frame_size
            self.pre_skip = 312
            self.backend = "libopus"

    def encode_i16_packets(self, samples: np.ndarray) -> List[bytes]:
        if self._own is not None:
            pcm = np.asarray(samples, dtype=np.float64)
            pcm = pcm.reshape(-1, self.channels) / 32768.0
            return self._own.push(pcm)
        return self._enc.push_i16(samples)

    def flush_packets(self) -> List[bytes]:
        if self._own is not None:
            return self._own.flush()
        return self._enc.flush()

    def encode_to_soundkit_stream(self, samples: np.ndarray) -> bytes:
        """soundkit raw-Opus framing: OpusHead + u16-LE length-prefixed."""
        head = struct.pack(
            "<8sBBHIhB", b"OpusHead", 1, self.channels, self.pre_skip,
            self.sample_rate, 0, 0,
        )
        pkts = self.encode_i16_packets(samples) + self.flush_packets()
        body = b"".join(struct.pack("<H", len(p)) + p for p in pkts)
        return head + body


# ---------------------------------------------------------------------------
# generic packet pipeline (audio_pipeline.rs:209-334)
# ---------------------------------------------------------------------------

class AudioEncoder:
    """WAV bytes in -> v1-headered packets, widow carry, flush container."""

    def __init__(self, encoding_flag: EncodingFlag, frame_size: int, encoder):
        self.encoding_flag = encoding_flag
        self.frame_size = frame_size
        self.encoder = encoder
        self._wav = WavStreamProcessor()
        self._packets: List[bytes] = []
        self._widow: Optional[AudioData] = None

    def add(self, data: bytes) -> None:
        audio = self._wav.add(data)
        while audio is not None:
            self._encode(audio, is_last=False)
            audio = self._wav.add(b"")

    def _encode(self, audio: AudioData, is_last: bool) -> None:
        chunk_size = self.frame_size * audio.channel_count * (audio.bits_per_sample // 8)
        data = audio.data
        if self._widow is not None:
            data = self._widow.data + data
            self._widow = None
        for off in range(0, len(data), chunk_size):
            chunk = data[off : off + chunk_size]
            if len(chunk) < chunk_size and not is_last:
                self._widow = AudioData(
                    audio.bits_per_sample, audio.channel_count, audio.sampling_rate,
                    chunk, audio.audio_format, audio.endianness,
                )
                return
            header = FrameHeader(
                encoding=audio.audio_format,
                sample_size=self.frame_size,
                sample_rate=audio.sampling_rate,
                channels=audio.channel_count,
                bits_per_sample=audio.bits_per_sample,
            )
            from soundkit_tpu_torch.core.audio_packet import encode_audio_packet

            packet = encode_audio_packet(
                self.encoding_flag, self.encoder, header.encode() + chunk
            )
            self._packets.append(packet)

    def flush(self) -> bytes:
        if self._widow is not None:
            widow, self._widow = self._widow, None
            self._encode(widow, is_last=True)
        offsets = []
        payload = bytearray()
        for p in self._packets:
            offsets.append(len(payload))
            payload.extend(p)
        out = bytearray(struct.pack("<I", len(offsets)))
        for o in offsets:
            out += struct.pack("<I", o)
        out += payload
        self._packets.clear()
        self._wav = WavStreamProcessor()
        return bytes(out)
