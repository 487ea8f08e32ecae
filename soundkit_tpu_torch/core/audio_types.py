"""Core interchange types.

Mirrors the behavior of the reference's core types:
``soundkit/src/audio_types.rs:3-36`` (``PcmData``/``AudioData``) and the
``frame-header`` crate's ``EncodingFlag``/``Endianness`` enums (3-bit
encoding flag mapping per ``soundkit/src/audio_packet.rs:43-49``).

``AudioData`` is THE interchange type: an interleaved byte buffer plus
format metadata.  ``PcmData`` is planar per-channel sample data; in this
framework channels are numpy arrays (host) so they can be moved to
device as a batch without per-sample Python cost.
"""
from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import List, Union

import numpy as np


class EncodingFlag(enum.IntEnum):
    """3-bit audio packet encoding flag (soundkit/src/audio_packet.rs:43-49)."""

    PCM_SIGNED = 0
    PCM_FLOAT = 1
    OPUS = 2
    FLAC = 3
    AAC = 4
    H264 = 5  # present in the frame-header crate; unused for audio decode


class Endianness(enum.IntEnum):
    LITTLE = 0
    BIG = 1


class PcmKind(enum.Enum):
    I16 = "i16"
    I32 = "i32"
    F32 = "f32"


_KIND_DTYPE = {
    PcmKind.I16: np.int16,
    PcmKind.I32: np.int32,
    PcmKind.F32: np.float32,
}


@dataclass
class PcmData:
    """Planar PCM: list of per-channel 1-D numpy arrays, all equal length.

    Equivalent of ``PcmData::{I16,I32,F32}(Vec<Vec<_>>)``
    (soundkit/src/audio_types.rs:3-7).
    """

    kind: PcmKind
    channels: List[np.ndarray] = field(default_factory=list)

    @classmethod
    def i16(cls, channels) -> "PcmData":
        return cls(PcmKind.I16, [np.asarray(c, dtype=np.int16) for c in channels])

    @classmethod
    def i32(cls, channels) -> "PcmData":
        return cls(PcmKind.I32, [np.asarray(c, dtype=np.int32) for c in channels])

    @classmethod
    def f32(cls, channels) -> "PcmData":
        return cls(PcmKind.F32, [np.asarray(c, dtype=np.float32) for c in channels])

    def __post_init__(self):
        dtype = _KIND_DTYPE[self.kind]
        self.channels = [np.asarray(c, dtype=dtype) for c in self.channels]
        if self.channels:
            n = len(self.channels[0])
            for c in self.channels:
                if len(c) != n:
                    raise ValueError("channel length mismatch")

    @property
    def channel_count(self) -> int:
        return len(self.channels)

    @property
    def sample_count(self) -> int:
        return len(self.channels[0]) if self.channels else 0


@dataclass(frozen=True)
class AudioData:
    """Interleaved encoded/PCM byte buffer + format metadata.

    Mirrors ``AudioData`` (soundkit/src/audio_types.rs:10-36).
    ``data`` is interleaved sample bytes for PCM formats.
    """

    bits_per_sample: int
    channel_count: int
    sampling_rate: int
    data: bytes
    audio_format: EncodingFlag = EncodingFlag.PCM_SIGNED
    endianness: Endianness = Endianness.LITTLE

    @property
    def bytes_per_sample(self) -> int:
        return self.bits_per_sample // 8

    @property
    def frame_count(self) -> int:
        denom = self.bytes_per_sample * self.channel_count
        return len(self.data) // denom if denom else 0

    @property
    def duration_seconds(self) -> float:
        return self.frame_count / self.sampling_rate if self.sampling_rate else 0.0


AudioLike = Union[AudioData, PcmData]
