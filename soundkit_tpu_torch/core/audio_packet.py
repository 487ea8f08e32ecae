"""Audio packet encode/decode with v1 frame headers.

Behavioral equivalent of ``soundkit/src/audio_packet.rs``:
``encode_audio_packet`` (header + format-specific sample conversion +
codec encode, :55-167) and ``decode_audio_packet`` /
``decode_audio_packet_scratch`` (:169-308) with the reference's exact
conversion matrix (e.g. PCMSigned-16 decodes with /32767 — i16::MAX —
unlike the /32768 used elsewhere).
"""
from __future__ import annotations

from typing import List, Optional, Protocol

import numpy as np

from soundkit_tpu_torch.core import audio_bytes as ab
from soundkit_tpu_torch.core.audio_types import AudioData, EncodingFlag, Endianness
from soundkit_tpu_torch.core.frame_header import FrameHeader, get_encoding_flag


class Encoder(Protocol):
    def encode_i16(self, samples: np.ndarray) -> bytes: ...
    def encode_i32(self, samples: np.ndarray) -> bytes: ...


class Decoder(Protocol):
    def decode_i16(self, data: bytes) -> np.ndarray: ...


class AudioList:
    """Planar f32 decode result (audio_packet.rs:28-32)."""

    def __init__(self, channels: List[np.ndarray], sample_count: int, sampling_rate: int):
        self.channels = channels
        self.sample_count = sample_count
        self.sampling_rate = sampling_rate


class AudioPacketError(ValueError):
    pass


def encode_audio_packet(
    encoding_format: EncodingFlag, encoder: Optional[Encoder], fullbuf: bytes
) -> bytes:
    """fullbuf = v1 header + interleaved PCM bytes -> header + encoded data."""
    header = FrameHeader.decode(fullbuf)
    buf = fullbuf[header.size() :]

    if encoding_format == EncodingFlag.FLAC:
        if header.bits_per_sample == 16:
            src = ab.s16le_to_i16(buf).astype(np.int32)
        elif header.bits_per_sample == 24:
            src = ab.s24le_to_i32(buf)
        elif header.bits_per_sample == 32:
            src = (
                ab.s32le_to_i32(buf)
                if header.encoding == EncodingFlag.PCM_SIGNED
                else ab.f32le_to_i32(buf)
            )
        else:
            raise AudioPacketError(f"Unsupported bits per sample: {header.bits_per_sample}")
        data = encoder.encode_i32(src)
        if not data:
            raise AudioPacketError("Flac encoding: zero bytes")
    elif encoding_format in (EncodingFlag.OPUS, EncodingFlag.AAC):
        if header.bits_per_sample == 16:
            src = ab.s16le_to_i16(buf)
        elif header.bits_per_sample == 24:
            src = ab.s24le_to_i16(buf)
        elif header.bits_per_sample == 32:
            if header.encoding == EncodingFlag.PCM_SIGNED:
                s32 = ab.s32le_to_i32(buf).astype(np.int64)
                scaled = (s32 * 32767) // 2147483647
            else:
                f = ab.f32le_to_f32(buf)
                scaled = np.trunc((f * np.float32(32767.0)).astype(np.float64)).astype(np.int64)
            src = np.clip(scaled, -32768, 32767).astype(np.int16)
        else:
            raise AudioPacketError(f"Unsupported bits per sample: {header.bits_per_sample}")
        data = encoder.encode_i16(src)
        if not data:
            raise AudioPacketError("Opus/AAC encoding: zero bytes")
    elif encoding_format == EncodingFlag.PCM_FLOAT:
        data = bytes(buf)
    else:
        data = b""

    out_header = FrameHeader(
        encoding=encoding_format,
        sample_size=header.sample_size,
        sample_rate=header.sample_rate,
        channels=header.channels,
        bits_per_sample=header.bits_per_sample,
        endianness=Endianness.LITTLE,
        id=header.id,
    )
    return out_header.encode() + data


def decode_audio_packet(
    buffer: bytes, decoder: Optional[Decoder] = None
) -> Optional[AudioList]:
    """Packet -> planar f32 (audio_packet.rs:237-308)."""
    header = FrameHeader.decode(buffer)
    channel_count = header.channels
    data = buffer[header.size() :]

    if header.encoding == EncodingFlag.PCM_SIGNED:
        if header.bits_per_sample == 16:
            samples = ab.s16le_to_i16(data).astype(np.float32) / np.float32(32767.0)
        elif header.bits_per_sample == 24:
            samples = ab.s24le_to_i32(data).astype(np.float32) / np.float32(1 << 23)
        elif header.bits_per_sample == 32:
            samples = ab.s32le_to_i32(data).astype(np.float32) / np.float32(2147483647.0)
        else:
            raise AudioPacketError(f"Unsupported bits per sample: {header.bits_per_sample}")
    elif header.encoding == EncodingFlag.PCM_FLOAT:
        samples = ab.f32le_to_f32(data)
    elif header.encoding == EncodingFlag.OPUS:
        pcm = decoder.decode_i16(data)
        samples = pcm.astype(np.float32) / np.float32(32767.0)
    else:
        raise AudioPacketError("Unsupported encoding type")

    n = len(samples) // channel_count if channel_count else 0
    mat = samples[: n * channel_count].reshape(n, channel_count)
    return AudioList(
        channels=[mat[:, c].astype(np.float32) for c in range(channel_count)],
        sample_count=header.sample_size,
        sampling_rate=header.sample_rate,
    )


__all__ = [
    "AudioList",
    "AudioPacketError",
    "Decoder",
    "Encoder",
    "decode_audio_packet",
    "encode_audio_packet",
    "get_encoding_flag",
]
