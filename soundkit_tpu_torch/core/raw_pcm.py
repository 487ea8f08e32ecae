"""Raw (headerless) PCM stream framing.

Behavioral equivalent of ``soundkit/src/raw_pcm.rs``:
``RawPcmSampleFormat`` (:4-33), ``RawPcmFormat`` with named profiles
``linear16`` / ``l16`` (big-endian) / ``linear32`` (:60-85), and
``RawPcmStreamProcessor`` whose ``add`` emits only whole interleaved
frames (:148-172) and whose ``flush`` errors on trailing partial-frame
bytes (:174-183).
"""
from __future__ import annotations

import enum
from dataclasses import dataclass
from typing import Optional

from soundkit_tpu_torch.core.audio_types import AudioData, EncodingFlag, Endianness


class RawPcmSampleFormat(enum.Enum):
    I16 = "i16"
    I24 = "i24"
    I32 = "i32"
    F32 = "f32"

    @property
    def bits_per_sample(self) -> int:
        return {"i16": 16, "i24": 24, "i32": 32, "f32": 32}[self.value]

    @property
    def bytes_per_sample(self) -> int:
        return self.bits_per_sample // 8

    @property
    def encoding_flag(self) -> EncodingFlag:
        return (
            EncodingFlag.PCM_FLOAT
            if self is RawPcmSampleFormat.F32
            else EncodingFlag.PCM_SIGNED
        )


@dataclass(frozen=True)
class RawPcmFormat:
    sample_rate: int
    channels: int
    sample_format: RawPcmSampleFormat
    endianness: Endianness

    def __post_init__(self):
        if self.sample_rate <= 0:
            raise ValueError("Raw PCM sample rate must be > 0")
        if self.channels <= 0:
            raise ValueError("Raw PCM channel count must be > 0")

    @classmethod
    def linear16(cls, sample_rate: int, channels: int) -> "RawPcmFormat":
        return cls(sample_rate, channels, RawPcmSampleFormat.I16, Endianness.LITTLE)

    @classmethod
    def l16(cls, sample_rate: int, channels: int) -> "RawPcmFormat":
        return cls(sample_rate, channels, RawPcmSampleFormat.I16, Endianness.BIG)

    @classmethod
    def linear32(cls, sample_rate: int, channels: int) -> "RawPcmFormat":
        return cls(sample_rate, channels, RawPcmSampleFormat.F32, Endianness.LITTLE)

    @property
    def bytes_per_frame(self) -> int:
        return self.sample_format.bytes_per_sample * self.channels

    @property
    def bits_per_sample(self) -> int:
        return self.sample_format.bits_per_sample

    @property
    def encoding_flag(self) -> EncodingFlag:
        return self.sample_format.encoding_flag


class RawPcmStreamProcessor:
    def __init__(self, fmt: RawPcmFormat) -> None:
        self.format = fmt
        self._buffer = bytearray()

    @property
    def buffered_len(self) -> int:
        return len(self._buffer)

    def add(self, chunk: bytes) -> Optional[AudioData]:
        self._buffer.extend(chunk)
        bpf = self.format.bytes_per_frame
        complete = (len(self._buffer) // bpf) * bpf
        if complete == 0:
            return None
        data = bytes(self._buffer[:complete])
        del self._buffer[:complete]
        return AudioData(
            bits_per_sample=self.format.bits_per_sample,
            channel_count=self.format.channels,
            sampling_rate=self.format.sample_rate,
            data=data,
            audio_format=self.format.encoding_flag,
            endianness=self.format.endianness,
        )

    def flush(self) -> Optional[AudioData]:
        if not self._buffer:
            return None
        raise ValueError(
            f"Raw PCM stream ended with {len(self._buffer)} trailing partial-frame byte(s)"
        )
