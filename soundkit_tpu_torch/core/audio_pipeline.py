"""PCM deserialization, f32 conversion, downmix, and resample entry.

Host-side equivalents of ``soundkit/src/audio_pipeline.rs``:
``deserialize_audio`` (:49-69), ``audio_to_f32_channels`` (:71-95,
including the 32-bit-signed special case), ``audio_to_mono_f32`` /
``mixdown_to_mono_f32`` (:97-128), and ``downsample_audio``
(:153-207) with the same rate/bit-depth whitelists.  The sinc kernel
itself lives in ``soundkit_tpu.ops.resample``.
"""
from __future__ import annotations

from typing import List

import numpy as np

from soundkit_tpu_torch.core import audio_bytes as ab
from soundkit_tpu_torch.core.audio_types import AudioData, EncodingFlag, PcmData, PcmKind

COMMON_SAMPLE_RATES = (8000, 16000, 22050, 24000, 32000, 44100, 48000, 88200, 96000)
COMMON_BITS_PER_SAMPLE = (16, 24, 32)


def deserialize_audio(data: bytes, bits_per_sample: int, channel_count: int) -> PcmData:
    """Interleaved bytes -> planar PcmData (audio_pipeline.rs:49-69).

    NOTE (reference quirk): 32-bit data is always deserialized as f32
    here; the signed-32 case is special-cased in audio_to_f32_channels.
    """
    if bits_per_sample == 16:
        return PcmData(PcmKind.I16, ab.deinterleave_vecs_i16(data, channel_count))
    if bits_per_sample == 24:
        return PcmData(PcmKind.I32, ab.deinterleave_vecs_s24(data, channel_count))
    if bits_per_sample == 32:
        return PcmData(PcmKind.F32, ab.deinterleave_vecs_f32(data, channel_count))
    raise ValueError("unsupported type")


def audio_to_f32_channels(audio: AudioData) -> List[np.ndarray]:
    """AudioData -> planar f32 channels (audio_pipeline.rs:71-95)."""
    channel_count = audio.channel_count
    if channel_count == 0:
        raise ValueError("Channel count must be > 0")

    if audio.bits_per_sample == 32 and audio.audio_format != EncodingFlag.PCM_FLOAT:
        interleaved = ab.s32le_to_i32(audio.data)
        n = len(interleaved) // channel_count
        mat = interleaved[: n * channel_count].reshape(n, channel_count)
        return [ab.vec_i32_to_f32(mat[:, c]) for c in range(channel_count)]

    pcm = deserialize_audio(audio.data, audio.bits_per_sample, channel_count)
    if pcm.kind is PcmKind.I16:
        return [ab.vec_i16_to_f32(c) for c in pcm.channels]
    if pcm.kind is PcmKind.I32:
        return [ab.vec_i32_to_f32(c) for c in pcm.channels]
    return list(pcm.channels)


def mixdown_to_mono_f32(channels: List[np.ndarray]) -> np.ndarray:
    """Average channels (audio_pipeline.rs:102-128)."""
    if not channels:
        return np.zeros(0, dtype=np.float32)
    if len(channels) == 1:
        return np.asarray(channels[0], dtype=np.float32).copy()
    n = len(channels[0])
    for c in channels:
        if len(c) != n:
            raise ValueError("channel length mismatch")
    mono = np.zeros(n, dtype=np.float32)
    for c in channels:
        mono += np.asarray(c, dtype=np.float32)
    return (mono * np.float32(1.0 / len(channels))).astype(np.float32)


def audio_to_mono_f32(audio: AudioData) -> np.ndarray:
    return mixdown_to_mono_f32(audio_to_f32_channels(audio))


def downsample_audio(audio: AudioData, sampling_rate: int) -> List[np.ndarray]:
    """One-shot sinc resample of one AudioData chunk (audio_pipeline.rs:153-207).

    Same validation matrix as the reference (whitelisted rates and bit
    depths); the kernel is the polyphase windowed-sinc in
    ``soundkit_tpu.ops.resample`` with rubato-SincFixedIn-equivalent
    parameters (sinc_len 256, f_cutoff 0.95, Blackman-Harris).
    """
    from soundkit_tpu_torch.ops import resample as rs

    if audio.channel_count == 0:
        raise ValueError("Channel count must be > 0")
    if audio.bits_per_sample not in COMMON_BITS_PER_SAMPLE:
        raise ValueError(f"Unsupported bits_per_sample: {audio.bits_per_sample}")
    if audio.sampling_rate == 0 or sampling_rate == 0:
        raise ValueError("sampling_rate must be > 0")
    if audio.sampling_rate not in COMMON_SAMPLE_RATES:
        raise ValueError(f"Unsupported input sample_rate: {audio.sampling_rate}")
    if sampling_rate not in COMMON_SAMPLE_RATES:
        raise ValueError(f"Unsupported output sample_rate: {sampling_rate}")

    channels = audio_to_f32_channels(audio)
    if not channels:
        return []

    batch = np.stack(channels, axis=0)
    out = rs.resample_np(batch, audio.sampling_rate, sampling_rate)
    return [out[c] for c in range(out.shape[0])]
