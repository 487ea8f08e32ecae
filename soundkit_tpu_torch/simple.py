"""Synchronous push/flush streaming API (counterpart of a subset of
``soundkit_tpu/simple.py``).

Thread-free push-based decoders: ``push(bytes)`` with arbitrary chunk
sizes returning zero or more frames, one ``flush()`` at EOF, errors as
exceptions, 8 KiB/64 KiB detection window:

- ``MusicDecoder``: full decode to PCM frames, with autodetect or
  ``new_with_format``, over ``pipeline.decode_pipeline.StreamDecoder``;
  its kernels run on ``device``, the card unless the caller names the
  CPU.
- ``AacDeboxer``: ADTS or M4A bytes -> raw AAC access units (an M4A
  stream is buffered and walked at ``flush`` by the owned MP4 demuxer,
  ``demux/mp4.py``).
- ``OpusDeboxer``: Ogg Opus or soundkit's raw framing -> Opus packets.
- ``AacLcStreamDecoder``: raw AUs -> PCM via the AAC-LC host decoder,
  interleaved or planar.
- ``OpusDecoder``: raw Opus packets -> interleaved int16 at 48 kHz
  through the owned RFC 6716 decoder (``codecs/opus_core.py``), with the
  reusable-output ``dec_frame`` / ``dec_frame_reuse``.
- ``AudioTrackDemuxer``: MP4, WebM or MPEG-TS bytes -> the track's
  ``AudioTrackConfig`` and ``AudioTrackPacket`` events, container only
  (``demux/audio_demux.py``; a LATM track parsed down to raw AUs).

- ``SoundKitFrameDecoder``: v2 frame stream -> payloads (with optional
  decrypt, ``core/frame_stream.py``).
- ``FlacEncoder``: planar f32 -> FLAC frame bytes; ``OpusEncoder``:
  interleaved i16 -> raw Opus packets (``codecs/encoders.py``, the owned
  encoders, on the host).
- ``AudioContentCipher``: ACE1 envelope seal / open;
  ``AudioContentKeyUnwrapper``: the content-key envelope open / seal.

The module imports without the ``cryptography`` package: only a
``SoundKitFrameDecoder`` given a ``decimal_key``, ``AudioContentCipher`` and
``AudioContentKeyUnwrapper`` reach it (``core/crypto.py``), and raise an
``ImportError`` that names it where it is missing.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

import numpy as np

from soundkit_tpu_torch.core.audio_types import AudioData
from soundkit_tpu_torch.core.crypto import ChaCha20Poly1305PacketCipher
from soundkit_tpu_torch.core.frame_stream import (
    SoundKitFrame,
    SoundKitFrameStream,
    SoundKitFrameStreamOptions,
)
from soundkit_tpu_torch.demux.detect import AudioType
from soundkit_tpu_torch.pipeline.decode_pipeline import StreamDecoder, _init_decoder
from soundkit_tpu_torch.pipeline.output_options import DecodeError, DecodeOptions
from soundkit_tpu_torch.utils.device import resolve_device

_FORMAT_NAMES = {
    "mp3": AudioType.MP3,
    "aac": AudioType.AAC,
    "m4a": AudioType.M4A,
    "flac": AudioType.FLAC,
    "wav": AudioType.WAV,
    "vorbis": AudioType.OGG_VORBIS,
    "ogg-opus": AudioType.OGG_OPUS,
    "opus": AudioType.OPUS,
    "speex": AudioType.OGG_SPEEX,
    "webm": AudioType.WEBM,
    "alac": AudioType.ALAC,
    "aiff": AudioType.AIFF,
    "ac3": AudioType.AC3,
}


@dataclass
class PcmFrame:
    """The per-frame JS object shape: {pcm, sampleRate, channels, bits}."""

    pcm: bytes
    sample_rate: int
    channels: int
    bits: int

    @classmethod
    def from_audio(cls, audio: AudioData) -> "PcmFrame":
        return cls(audio.data, audio.sampling_rate, audio.channel_count, audio.bits_per_sample)


class MusicDecoder:
    """Full decode to PCM frames."""

    def __init__(self, options: DecodeOptions = DecodeOptions(), initial_decoder=None,
                 device="cuda"):
        self._core = StreamDecoder(options, initial_decoder, device)

    @classmethod
    def new_with_format(cls, fmt: str, options: DecodeOptions = DecodeOptions(),
                        device="cuda") -> "MusicDecoder":
        try:
            audio_type = _FORMAT_NAMES[fmt]
        except KeyError:
            raise ValueError(f"unknown format {fmt!r}")
        return cls(options, _init_decoder(audio_type, resolve_device(device)), device)

    def push(self, data: bytes) -> List[PcmFrame]:
        return self._collect(self._core.process(bytes(data)) if data else [])

    def flush(self) -> List[PcmFrame]:
        return self._collect(self._core.process(b""))

    @staticmethod
    def _collect(outputs) -> List[PcmFrame]:
        frames = []
        for o in outputs:
            if isinstance(o, DecodeError):
                raise o
            frames.append(PcmFrame.from_audio(o))
        return frames


class AacDeboxer:
    """WasmAacDeboxer mirror: ADTS or M4A bytes -> raw access units."""

    def __init__(self) -> None:
        from soundkit_tpu_torch.codecs.aac_lc import AdtsStream

        self._adts = AdtsStream()
        self._maybe_mp4 = bytearray()
        self._mode: Optional[str] = None
        self.audio_specific_config: bytes = b""

    def push(self, data: bytes) -> List[bytes]:
        if self._mode is None:
            self._maybe_mp4.extend(data)
            if len(self._maybe_mp4) < 12:
                return []
            if self._maybe_mp4[4:8] == b"ftyp":
                self._mode = "mp4"
                return []  # buffered already; EOF-decoded at flush
            self._mode = "adts"
            data = bytes(self._maybe_mp4)
            self._maybe_mp4.clear()
        if self._mode == "adts":
            aus = self._adts.push(data)
            if self._adts.sr_index is not None and not self.audio_specific_config:
                sr, ch = self._adts.sr_index, self._adts.channel_config
                self.audio_specific_config = bytes(
                    [(2 << 3) | (sr >> 1), ((sr & 1) << 7) | (ch << 3)]
                )
            return aus
        self._maybe_mp4.extend(data)
        return []

    def flush(self) -> List[bytes]:
        if self._mode == "mp4":
            from soundkit_tpu_torch.demux.mp4 import demux_mp4_audio

            track = demux_mp4_audio(bytes(self._maybe_mp4))
            self._maybe_mp4.clear()
            self.audio_specific_config = track.config
            return list(track.samples)
        return []


class OpusDeboxer:
    """WasmOpusDeboxer mirror: Ogg / raw-framing -> Opus packets."""

    def __init__(self) -> None:
        self._buf = bytearray()
        self._mode: Optional[str] = None
        self._ogg = None
        self._raw = None
        self.opus_head: bytes = b""

    def push(self, data: bytes) -> List[bytes]:
        if self._mode is None:
            self._buf.extend(data)
            if len(self._buf) < 8:
                return []
            if self._buf[:4] == b"OggS":
                from soundkit_tpu_torch.codecs.opus import OggOpusDemuxer

                self._mode, self._ogg = "ogg", OggOpusDemuxer()
            elif self._buf[:8] == b"OpusHead":
                self._mode = "raw"
            else:
                raise ValueError("not an Opus stream")
            data = bytes(self._buf)
            self._buf.clear()
        if self._mode == "ogg":
            pkts = self._ogg.push(data)
            if self._ogg.head is not None and not self.opus_head:
                self.opus_head = self._ogg.head.raw
            return pkts
        # raw soundkit framing
        import struct

        self._buf.extend(data)
        out = []
        if not self.opus_head:
            if len(self._buf) < 19:
                return []
            self.opus_head = bytes(self._buf[:19])
            del self._buf[:19]
        while len(self._buf) >= 2:
            plen = struct.unpack_from("<H", self._buf, 0)[0]
            if len(self._buf) < 2 + plen:
                break
            out.append(bytes(self._buf[2 : 2 + plen]))
            del self._buf[: 2 + plen]
        return out

    def flush(self) -> List[bytes]:
        return []


class AacLcStreamDecoder:
    """WasmAacLcDecoder mirror: raw AUs -> PCM via our own AAC-LC."""

    def __init__(self, audio_specific_config: bytes):
        from soundkit_tpu_torch.codecs.aac_lc import AacLcDecoder
        from soundkit_tpu_torch.ops.aac_dsp import AacLcSynth

        if len(audio_specific_config) < 2:
            raise ValueError("AudioSpecificConfig too short")
        asc = audio_specific_config
        object_type = asc[0] >> 3
        sr_index = ((asc[0] & 0x7) << 1) | (asc[1] >> 7)
        self.channels = (asc[1] >> 3) & 0xF
        if object_type != 2:
            raise ValueError(f"only AAC-LC supported (object type {object_type})")
        self._dec = AacLcDecoder(sr_index)
        self._synth = AacLcSynth(sr_index)
        from soundkit_tpu_torch.codecs.aac_lc import SAMPLE_RATES

        self.sample_rate = SAMPLE_RATES[sr_index]

    def decode_planar(self, au: bytes) -> np.ndarray:
        frame = self._dec.decode_au(au)
        return self._synth.process_frame(frame)  # [C, 1024]

    def decode_interleaved(self, au: bytes) -> np.ndarray:
        return self.decode_planar(au).T.reshape(-1)

    def decode_interleaved_into(self, au: bytes, out: np.ndarray) -> int:
        pcm = self.decode_interleaved(au)
        out[: len(pcm)] = pcm
        return len(pcm)


class AudioTrackDemuxer:
    """WasmAudioTrackDemuxer mirror (lib.rs:605-636): arbitrary
    container bytes in, ``AudioTrackConfig``/``AudioTrackPacket``
    events out — container-only, no codec decode."""

    def __init__(self) -> None:
        from soundkit_tpu_torch.demux.audio_demux import AudioTrackDemuxer as _Core

        self._core = _Core.new_auto()

    @classmethod
    def new_auto(cls) -> "AudioTrackDemuxer":
        return cls()

    @classmethod
    def new_with_format(cls, fmt: str) -> "AudioTrackDemuxer":
        from soundkit_tpu_torch.demux.audio_demux import AudioTrackDemuxer as _Core

        self = cls.__new__(cls)
        self._core = _Core.new_with_format(fmt)
        return self

    def push(self, data: bytes) -> list:
        return self._core.push(bytes(data))

    def flush(self) -> list:
        return self._core.flush()


class FlacEncoder:
    """WasmFlacEncoder mirror (lib.rs:763-818): planar f32 frames ->
    FLAC frame bytes (encode_planar_f32 semantics incl. the i32
    conversion at the declared bit depth)."""

    def __init__(self, sample_rate: int, channels: int,
                 bits_per_sample: int = 16, frame_size: int = 0,
                 compression_level: int = 5):
        from soundkit_tpu_torch.codecs import encoders

        self._args = (sample_rate, bits_per_sample, channels, frame_size,
                      compression_level)
        self._enc = encoders.FlacEncoder(*self._args)
        self.channels = channels
        self.bits_per_sample = bits_per_sample

    def encode_planar_f32(self, planar: np.ndarray,
                          frames_per_channel: int) -> bytes:
        """``planar``: channel-major [C * frames] f32 in [-1, 1]."""
        c, n = self.channels, int(frames_per_channel)
        planar = np.asarray(planar, np.float32)
        if planar.size < c * n:
            raise ValueError(
                f"planar input too short: need {c * n} samples, got {planar.size}"
            )
        chans = planar[: c * n].reshape(c, n)
        scale = float(1 << (self.bits_per_sample - 1))
        inter = np.clip(
            np.rint(chans.T.reshape(-1).astype(np.float64) * scale),
            -scale, scale - 1,
        ).astype(np.int64)
        return self._enc.encode_i32(inter)

    def flush(self) -> bytes:
        return self._enc.flush()

    def reset(self) -> None:
        from soundkit_tpu_torch.codecs import encoders

        self._enc = encoders.FlacEncoder(*self._args)


class OpusEncoder:
    """WasmOpusEncoder mirror (lib.rs:827-869): interleaved i16 in,
    raw Opus packets out.  ``frame_size`` follows the underlying
    encoder (exposed as an attribute like the reference's constructor
    parameter); short final frames are the caller's to zero-pad, as in
    the reference contract."""

    def __init__(self, sample_rate: int = 48000, channels: int = 2,
                 bitrate: int = 64000, frame_size: int = 0):
        from soundkit_tpu_torch.codecs import encoders

        self._args = (sample_rate, channels, bitrate)
        self._enc = encoders.OpusEncoder(*self._args)
        self.frame_size = self._enc.frame_size
        self.channels = channels

    def encode_interleaved_i16(self, interleaved: np.ndarray) -> List[bytes]:
        required = self.frame_size * self.channels
        samples = np.asarray(interleaved, np.int16)
        if samples.size < required:
            raise ValueError(
                f"opus encode input too short: need {required} samples, "
                f"got {samples.size}"
            )
        return self._enc.encode_i16_packets(samples[:required])

    def flush(self) -> List[bytes]:
        return self._enc.flush_packets()

    def reset(self) -> None:
        from soundkit_tpu_torch.codecs import encoders

        self._enc = encoders.OpusEncoder(*self._args)


class AudioContentCipher:
    """WasmAudioContentCipher mirror (lib.rs:61-99): ACE1 envelope
    seal/open with key-epoch binding and canonical AAD."""

    def __init__(self, key: bytes):
        from soundkit_tpu_torch.core.audio_content_crypto import (
            AudioContentCipher as _Core,
        )

        self._core = _Core(bytes(key))

    def seal(self, key_epoch: int, nonce: bytes, plaintext: bytes,
             authenticated_data: bytes = b"") -> bytes:
        return self._core.seal(key_epoch, bytes(nonce), bytes(plaintext),
                               bytes(authenticated_data))

    def open(self, expected_key_epoch: int, envelope: bytes,
             authenticated_data: bytes = b"") -> bytes:
        return self._core.open(expected_key_epoch, bytes(envelope),
                               bytes(authenticated_data))


class SoundKitFrameDecoder:
    """WasmSoundKitFrameDecoder mirror: v2 frames -> payloads."""

    def __init__(self, decimal_key: Optional[str] = None):
        cipher = (
            ChaCha20Poly1305PacketCipher.new_from_decimal_key(decimal_key)
            if decimal_key
            else None
        )
        self._stream = SoundKitFrameStream(SoundKitFrameStreamOptions(cipher=cipher))

    def push(self, data: bytes) -> List[SoundKitFrame]:
        return self._stream.push(data)

    def flush(self) -> List[SoundKitFrame]:
        self._stream.finish()
        return []


class AudioContentKeyUnwrapper:
    """WasmAudioContentKeyUnwrapper mirror (lib.rs:106-163): opens and
    seals the endpoint-specific envelope that transports a 32-byte
    audio content key under a P-256 ECDH + HKDF-SHA256 wrapping key
    (the wrapping-key derivation happens outside this surface; the
    caller supplies the canonical key-exchange context as AAD)."""

    NONCE_LEN = 12
    KEY_LEN = 32
    SEALED_LEN = 48  # 32-byte key + 16-byte Poly1305 tag

    def __init__(self, key: bytes):
        key = bytes(key)
        if len(key) != self.KEY_LEN or not any(key):
            raise ValueError("invalid audio content wrapping key")
        self._cipher = ChaCha20Poly1305PacketCipher(key)

    def open(self, nonce: bytes, ciphertext: bytes,
             authenticated_data: bytes = b"") -> bytes:
        nonce, ciphertext = bytes(nonce), bytes(ciphertext)
        if len(nonce) != self.NONCE_LEN or len(ciphertext) != self.SEALED_LEN:
            raise ValueError("invalid audio content key envelope")
        plaintext = self._cipher.decrypt_nonce_prefixed(
            nonce + ciphertext, bytes(authenticated_data)
        )
        if len(plaintext) != self.KEY_LEN or not any(plaintext):
            raise ValueError("invalid audio content key")
        return plaintext

    def seal(self, nonce: bytes, plaintext: bytes,
             authenticated_data: bytes = b"") -> bytes:
        nonce, plaintext = bytes(nonce), bytes(plaintext)
        if (len(nonce) != self.NONCE_LEN or len(plaintext) != self.KEY_LEN
                or not any(plaintext)):
            raise ValueError("invalid audio content key")
        packet = self._cipher.encrypt_nonce_prefixed(
            nonce, plaintext, bytes(authenticated_data)
        )
        return packet[self.NONCE_LEN:]  # ciphertext only, as the reference


@dataclass
class OpusDecodeResult:
    """WasmOpusDecodeResult mirror (lib.rs:279): a decoded packet's
    interleaved i16 buffer plus the samples-per-channel count."""

    output: np.ndarray  # interleaved int16, frame_size * channels long
    decoded_size: int
    channels: int

    def pcm(self) -> np.ndarray:
        """The valid interleaved samples."""
        return self.output[: self.decoded_size * self.channels]


class OpusDecoder:
    """WasmOpusDecoder mirror (lib.rs:271,872-932): per-packet raw
    Opus decode to interleaved i16 at 48 kHz through the framework's
    OWN RFC 6716 decoder (codecs/opus_core.py), with the reference's
    reusable-output contract: ``dec_frame`` returns a result snapshot,
    ``dec_frame_reuse`` decodes into ``self.output`` and returns the
    samples-per-channel count."""

    def __init__(self, channels: int, sample_rate: int = 48000,
                 frame_size: int = 960):
        if sample_rate != 48000:
            raise ValueError(
                "soundkit currently supports 48 kHz Opus decode"
            )
        from soundkit_tpu_torch.codecs.opus_core import OpusDecoder as _Own

        self.channels = channels
        self._dec = _Own(channels)
        out_len = max(frame_size * channels, max(channels, 1))
        self.output = np.zeros(out_len, np.int16)
        self.decoded_size = 0

    def dec_frame(self, packet: bytes) -> OpusDecodeResult:
        self.dec_frame_reuse(packet)
        return OpusDecodeResult(self.output.copy(), self.decoded_size,
                                self.channels)

    def dec_frame_reuse(self, packet: bytes) -> int:
        pcm = np.asarray(self._dec.decode_packet(bytes(packet)),
                         np.float32).reshape(-1)
        # libopus decode_i16 conversion: round(x * 32768), saturated
        i16 = np.clip(
            np.rint(pcm.astype(np.float64) * 32768.0), -32768, 32767
        ).astype(np.int16)
        n = i16.size
        if n > self.output.size:
            self.output = np.zeros(n, np.int16)
        self.output[:n] = i16
        self.output[n:] = 0
        self.decoded_size = n // max(self.channels, 1)
        return self.decoded_size

    def destroy(self) -> None:
        """Reference-API parity no-op (wasm frees its linear memory)."""
