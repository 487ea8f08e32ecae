"""Offline time-stretch / pitch-shift API.

Behavioral equivalent of ``soundkit-rubberband/src/lib.rs``:
``OfflineStretchConfig`` with ``recommended_for_music`` and builder
methods (:54-122), ``recommended_config_for_audio`` (:175),
``stretch_audio_data`` / ``_to_pcm`` / ``_preserve_format``
(:299-331), ``stretch_interleaved`` / ``stretch_deinterleaved``
(:333-351) — backed by the framework's own phase-vocoder kernel
(ops.stretch) instead of the GPL Rubber Band C++ library.
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import List

import numpy as np

from soundkit_tpu_torch.core import audio_bytes as ab
from soundkit_tpu_torch.core.audio_pipeline import audio_to_f32_channels
from soundkit_tpu_torch.core.audio_types import AudioData, EncodingFlag, Endianness, PcmData
from soundkit_tpu_torch.ops.stretch import stretch_pitch

DEFAULT_CHUNK_FRAMES = 4096


class StretchError(ValueError):
    pass


@dataclass(frozen=True)
class OfflineStretchConfig:
    sample_rate: int
    channels: int
    time_ratio: float = 1.0
    pitch_scale: float = 1.0
    # Reference semantics (lib.rs:628-630): formant_scale != 1.0 pins
    # the spectral envelope at formant_scale x the original formant
    # frequencies, independent of pitch_scale.  formant_preserved
    # mirrors the FORMANT_PRESERVED option bit (lib.rs:45): envelope
    # stays at the original frequencies while pitch moves.
    formant_scale: float = 1.0
    formant_preserved: bool = False
    chunk_frames: int = DEFAULT_CHUNK_FRAMES

    @classmethod
    def recommended_for_music(cls, sample_rate: int, channels: int) -> "OfflineStretchConfig":
        return cls(sample_rate=sample_rate, channels=channels)

    def with_time_ratio(self, r: float) -> "OfflineStretchConfig":
        return replace(self, time_ratio=r)

    def with_pitch_scale(self, p: float) -> "OfflineStretchConfig":
        return replace(self, pitch_scale=p)

    def with_formant_scale(self, f: float) -> "OfflineStretchConfig":
        return replace(self, formant_scale=f)

    def with_formant_preserved(self, on: bool = True) -> "OfflineStretchConfig":
        return replace(self, formant_preserved=on)

    def effective_formant_scale(self):
        """None = envelope follows pitch (default); else the explicit
        envelope scale relative to the original formants."""
        if self.formant_preserved or abs(self.formant_scale - 1.0) > 1e-9:
            return self.formant_scale
        return None

    def with_chunk_frames(self, n: int) -> "OfflineStretchConfig":
        return replace(self, chunk_frames=n)

    def validate(self) -> None:
        if self.sample_rate <= 0 or self.channels <= 0:
            raise StretchError("sample_rate and channels must be > 0")
        if not 0.01 <= self.time_ratio <= 100.0:
            raise StretchError("time_ratio out of range")
        if not 0.25 <= self.pitch_scale <= 4.0:
            raise StretchError("pitch_scale out of range")
        if not (np.isfinite(self.formant_scale) and self.formant_scale > 0.0):
            raise StretchError("formant_scale must be finite and > 0")


def recommended_config_for_audio(audio: AudioData) -> OfflineStretchConfig:
    return OfflineStretchConfig.recommended_for_music(
        audio.sampling_rate, audio.channel_count
    )


def stretch_deinterleaved(
    channels: List[np.ndarray], config: OfflineStretchConfig
) -> List[np.ndarray]:
    config.validate()
    if len(channels) != config.channels:
        raise StretchError(
            f"expected {config.channels} channels, got {len(channels)}"
        )
    x = np.stack([np.asarray(c, np.float32) for c in channels], axis=0)
    out = stretch_pitch(
        x, config.time_ratio, config.pitch_scale,
        formant_scale=config.effective_formant_scale(),
    )
    return [out[c] for c in range(out.shape[0])]


def stretch_interleaved(
    interleaved: np.ndarray, config: OfflineStretchConfig
) -> np.ndarray:
    config.validate()
    x = np.asarray(interleaved, np.float32)
    if len(x) % config.channels:
        raise StretchError(
            f"interleaved length {len(x)} is not a multiple of "
            f"{config.channels} channels"
        )
    n = len(x) // config.channels
    planar = [x[c :: config.channels][:n] for c in range(config.channels)]
    out = stretch_deinterleaved(planar, config)
    return np.stack(out, axis=1).reshape(-1)


def stretch_audio_data(audio: AudioData, config: OfflineStretchConfig) -> AudioData:
    """Stretch; output is planar->interleaved 32-bit float AudioData."""
    channels = audio_to_f32_channels(audio)
    out = stretch_deinterleaved(channels, config)
    data = np.stack(out, axis=1).astype("<f4").tobytes()
    return AudioData(
        bits_per_sample=32,
        channel_count=audio.channel_count,
        sampling_rate=audio.sampling_rate,
        data=data,
        audio_format=EncodingFlag.PCM_FLOAT,
        endianness=Endianness.LITTLE,
    )


def stretch_audio_data_to_pcm(audio: AudioData, config: OfflineStretchConfig) -> PcmData:
    channels = audio_to_f32_channels(audio)
    return PcmData.f32(stretch_deinterleaved(channels, config))


def stretch_audio_data_preserve_format(
    audio: AudioData, config: OfflineStretchConfig
) -> AudioData:
    """Stretch, then convert back to the input's sample format."""
    channels = audio_to_f32_channels(audio)
    out = stretch_deinterleaved(channels, config)
    from soundkit_tpu_torch.pipeline.output_options import f32_channels_to_bytes

    data = f32_channels_to_bytes(out, audio.bits_per_sample, audio.audio_format)
    return AudioData(
        bits_per_sample=audio.bits_per_sample,
        channel_count=audio.channel_count,
        sampling_rate=audio.sampling_rate,
        data=data,
        audio_format=audio.audio_format,
        endianness=Endianness.LITTLE,
    )
