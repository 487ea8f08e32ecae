"""DecodeOptions output conversion.

Behavioral equivalent of the reference's output stage
(soundkit-decoder/src/lib.rs): ``apply_output_options`` (:1314-1436),
``downmix_channels`` (:1438-1507), ``f32_channels_to_bytes``
(:1539-1576) with the exact ``vec_f32_to_s24``/``vec_f32_to_i32``
scaling (:1578-1607).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

import numpy as np

from soundkit_tpu_torch.core import audio_bytes as ab
from soundkit_tpu_torch.core.audio_pipeline import audio_to_f32_channels
from soundkit_tpu_torch.core.audio_types import AudioData, EncodingFlag, Endianness
from soundkit_tpu_torch.pipeline.resampler import StreamingResampler


@dataclass(frozen=True)
class DecodeOptions:
    """soundkit-decoder/src/lib.rs:88-92."""

    output_bits_per_sample: Optional[int] = None
    output_sample_rate: Optional[int] = None
    output_channels: Optional[int] = None


class DecodeError(Exception):
    pass


class FormatDetectionFailed(DecodeError):
    def __str__(self):
        return "Failed to detect audio format"


class DecoderInitFailed(DecodeError):
    pass


class DecodingFailed(DecodeError):
    pass


class NoAudioDecoded(DecodeError):
    """The detected decoder consumed the whole stream without emitting
    a single PCM frame (e.g. a syncword coincidence routed a corrupt
    stream into a decoder that skipped everything). Distinguishes
    'decoded to nothing' from a clean empty result at EOF."""

    def __str__(self):
        return "Stream ended without any decodable audio"


class InputBufferFull(DecodeError):
    def __str__(self):
        return "Input buffer full"


class UnsupportedFormat(DecodeError):
    pass


class InvalidInputFormat(DecodeError):
    pass


def _vec_f32_to_i32(x: np.ndarray) -> np.ndarray:
    c = np.clip(np.asarray(x, np.float32), np.float32(-1.0), np.float32(1.0))
    scaled = (c * np.float32(2147483648.0)).astype(np.float32)
    return np.clip(np.trunc(scaled.astype(np.float64)), -2147483648, 2147483647).astype(np.int32)


def _vec_f32_to_s24(x: np.ndarray) -> np.ndarray:
    c = np.clip(np.asarray(x, np.float32), np.float32(-1.0), np.float32(1.0))
    scaled = np.where(
        c >= 0,
        (c * np.float32(8388607.0)).astype(np.float32),
        (c * np.float32(8388608.0)).astype(np.float32),
    )
    return np.trunc(scaled.astype(np.float64)).astype(np.int32)


def f32_channels_to_bytes(
    channels: List[np.ndarray], bits_per_sample: int, output_format: EncodingFlag
) -> bytes:
    if not channels:
        return b""
    n = len(channels[0])
    for c in channels:
        if len(c) != n:
            raise DecodingFailed("Channel length mismatch")
    if output_format == EncodingFlag.PCM_FLOAT:
        if bits_per_sample != 32:
            raise DecodingFailed("PCMFloat output requires 32-bit samples")
        return np.stack(channels, axis=1).astype("<f4").tobytes()
    if bits_per_sample == 16:
        return np.stack([ab.vec_f32_to_i16(c) for c in channels], axis=1).astype("<i2").tobytes()
    if bits_per_sample == 24:
        i32 = np.stack([_vec_f32_to_s24(c) for c in channels], axis=1).reshape(-1)
        return ab.i32_to_s24le(i32)
    if bits_per_sample == 32:
        return np.stack([_vec_f32_to_i32(c) for c in channels], axis=1).astype("<i4").tobytes()
    raise DecodingFailed(f"Unsupported output bits per sample: {bits_per_sample}")


def downmix_channels(channels: List[np.ndarray], target: int) -> List[np.ndarray]:
    """soundkit-decoder/src/lib.rs:1438-1507."""
    if not channels or target == 0:
        return []
    n = len(channels[0])
    if target == 1:
        mono = np.zeros(n, np.float32)
        scale = np.float32(1.0 / len(channels))
        for c in channels:
            mono += np.asarray(c, np.float32) * scale
        return [mono.astype(np.float32)]
    if target == 2 and len(channels) > 2:
        left = np.asarray(channels[0], np.float32).copy()
        right = np.asarray(channels[1], np.float32).copy()
        coef = np.float32(0.707)
        if len(channels) > 2:
            left += coef * channels[2]
            right += coef * channels[2]
        if len(channels) > 4:
            left += coef * channels[4]
            if len(channels) > 5:
                right += coef * channels[5]
        peak = max(np.abs(left).max(initial=0.0), np.abs(right).max(initial=0.0))
        if peak > 1.0:
            left *= np.float32(1.0 / peak)
            right *= np.float32(1.0 / peak)
        return [left.astype(np.float32), right.astype(np.float32)]
    return [np.asarray(c, np.float32) for c in channels[:target]]


def apply_output_options(
    audio: AudioData,
    options: DecodeOptions,
    resampler_box: List[Optional[StreamingResampler]],
) -> List[AudioData]:
    """Convert one decoded AudioData per the options; ``resampler_box``
    is a single-element list holding the persistent StreamingResampler."""
    target_rate = options.output_sample_rate or audio.sampling_rate
    target_bits = options.output_bits_per_sample or audio.bits_per_sample
    target_channels = options.output_channels or audio.channel_count

    if (
        target_rate == audio.sampling_rate
        and target_bits == audio.bits_per_sample
        and target_channels == audio.channel_count
    ):
        return [audio]

    if target_rate == 0:
        raise DecodingFailed("Output sample rate must be > 0")
    if target_bits not in (16, 24, 32):
        raise DecodingFailed(f"Unsupported output bits per sample: {target_bits}")
    if target_channels == 0:
        raise DecodingFailed("Output channels must be > 0")

    output_format = (
        EncodingFlag.PCM_FLOAT
        if target_bits == 32 and audio.audio_format == EncodingFlag.PCM_FLOAT
        else EncodingFlag.PCM_SIGNED
    )

    channels = audio_to_f32_channels(audio)

    if target_rate != audio.sampling_rate:
        if audio.sampling_rate == 0:
            raise DecodingFailed("Input sample rate must be > 0")
        active = resampler_box[0]
        if active is not None:
            if (
                active.input_rate != audio.sampling_rate
                or active.channels != len(channels)
                or active.output_rate != target_rate
            ):
                raise DecodingFailed("Resampler configuration changed mid-stream")
        else:
            active = StreamingResampler(audio.sampling_rate, target_rate, len(channels))
            resampler_box[0] = active
        out = active.process(np.stack(channels, axis=0))
        channels = [out[c] for c in range(out.shape[0])]
        if not channels or len(channels[0]) == 0:
            return []

    if target_channels < len(channels):
        channels = downmix_channels(channels, target_channels)
    out_ch = len(channels)

    data = f32_channels_to_bytes(channels, target_bits, output_format)
    return [
        AudioData(
            bits_per_sample=target_bits,
            channel_count=out_ch,
            sampling_rate=target_rate,
            data=data,
            audio_format=output_format,
            endianness=Endianness.LITTLE,
        )
    ]
