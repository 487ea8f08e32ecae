"""Incremental WAV/RIFF parsing and WAV synthesis.

Behavioral equivalent of ``soundkit/src/wav.rs``:

- ``WavStreamProcessor`` (wav.rs:14-198): a chunk-boundary-agnostic RIFF
  state machine Initial -> ReadToFmt -> ReadingFmt -> ReadToData ->
  ReadingData -> Finished that emits whole-frame runs of interleaved
  sample bytes as they arrive.  fmt tag 1 => PCM signed, 3 => IEEE
  float, anything else treated as float (wav.rs:120-124).
- ``generate_wav_buffer`` (wav.rs:201-270): planar ``PcmData`` ->
  complete RIFF/WAVE byte buffer (16-bit PCM, 32-bit PCM or 32-bit
  float).
"""
from __future__ import annotations

import enum
import struct
from typing import Optional

import numpy as np

from soundkit_tpu_torch.core.audio_types import (
    AudioData,
    EncodingFlag,
    Endianness,
    PcmData,
    PcmKind,
)


class _State(enum.Enum):
    INITIAL = 0
    READ_TO_FMT = 1
    READING_FMT = 2
    READ_TO_DATA = 3
    READING_DATA = 4
    FINISHED = 5


class WavStreamError(ValueError):
    pass


class WavStreamProcessor:
    """Streaming RIFF parser emitting ``AudioData`` frame runs."""

    def __init__(self) -> None:
        self._state = _State.INITIAL
        self._buffer = bytearray()
        self._idx = 0
        self.bits_per_sample = 0
        self.channel_count = 0
        self.sampling_rate = 0
        self.audio_format = EncodingFlag.PCM_SIGNED
        self.endianness = Endianness.LITTLE
        self._data_chunk_size = 0
        self._data_chunk_collected = 0

    @property
    def finished(self) -> bool:
        return self._state is _State.FINISHED

    def add(self, chunk: bytes) -> Optional[AudioData]:
        self._buffer.extend(chunk)
        buf = self._buffer

        while True:
            if self._state is _State.INITIAL:
                if len(buf) < 12:
                    return None
                if bytes(buf[:4]) != b"RIFF" or bytes(buf[8:12]) != b"WAVE":
                    raise WavStreamError("Not a WAV file")
                self._state = _State.READ_TO_FMT
                self._idx = 12

            elif self._state is _State.READ_TO_FMT:
                if len(buf) < self._idx + 4:
                    return None
                while bytes(buf[self._idx : self._idx + 4]) != b"fmt ":
                    # need tag + size of the chunk being skipped
                    # (guard added vs wav.rs:92-100, which can panic here
                    # on pathological chunking)
                    if len(buf) < self._idx + 8:
                        return None
                    size = struct.unpack_from("<I", buf, self._idx + 4)[0]
                    self._idx += size + 8
                    if len(buf) < self._idx + 8:
                        return None
                self._state = _State.READING_FMT

            elif self._state is _State.READING_FMT:
                if len(buf) < self._idx + 24:
                    return None
                fmt = bytes(buf[self._idx : self._idx + 24])
                tag = struct.unpack_from("<H", fmt, 8)[0]
                self.channel_count = struct.unpack_from("<H", fmt, 10)[0]
                self.sampling_rate = struct.unpack_from("<I", fmt, 12)[0]
                self.bits_per_sample = struct.unpack_from("<H", fmt, 22)[0]
                self.audio_format = (
                    EncodingFlag.PCM_SIGNED if tag == 1 else EncodingFlag.PCM_FLOAT
                )
                self.endianness = Endianness.LITTLE
                size = struct.unpack_from("<I", buf, self._idx + 4)[0]
                self._idx += size + 8
                self._state = _State.READ_TO_DATA

            elif self._state is _State.READ_TO_DATA:
                if len(buf) < self._idx + 4:
                    return None
                while bytes(buf[self._idx : self._idx + 4]) != b"data":
                    if len(buf) < self._idx + 8:
                        return None
                    size = struct.unpack_from("<I", buf, self._idx + 4)[0]
                    self._idx += size + 8
                    if len(buf) < self._idx + 8:
                        return None
                if len(buf) < self._idx + 8:
                    return None
                self._data_chunk_size = struct.unpack_from("<I", buf, self._idx + 4)[0]
                self._state = _State.READING_DATA
                del buf[: self._idx + 8]
                self._idx = 0

            elif self._state is _State.READING_DATA:
                bytes_per_frame = (self.bits_per_sample // 8) * self.channel_count
                if len(buf) < bytes_per_frame or bytes_per_frame == 0:
                    return None
                frames = len(buf) // bytes_per_frame
                run = frames * bytes_per_frame
                data = bytes(buf[:run])
                del buf[:run]
                self._data_chunk_collected += run
                if self._data_chunk_collected == self._data_chunk_size:
                    self._state = _State.FINISHED
                return AudioData(
                    bits_per_sample=self.bits_per_sample,
                    channel_count=self.channel_count,
                    sampling_rate=self.sampling_rate,
                    data=data,
                    audio_format=self.audio_format,
                    endianness=self.endianness,
                )

            else:  # FINISHED
                return None


def generate_wav_buffer(pcm: PcmData, sampling_rate: int) -> bytes:
    """Planar PCM -> complete RIFF/WAVE buffer (wav.rs:201-270)."""
    bits = 16 if pcm.kind is PcmKind.I16 else 32
    fmt_tag = 3 if pcm.kind is PcmKind.F32 else 1
    channel_count = pcm.channel_count
    sample_count = pcm.sample_count
    bytes_per_sample = bits // 8
    byte_rate = sampling_rate * bytes_per_sample * channel_count
    block_align = bytes_per_sample * channel_count
    data_size = sample_count * bytes_per_sample * channel_count

    out = bytearray()
    out += b"RIFF" + struct.pack("<I", 36 + data_size) + b"WAVE"
    out += b"fmt " + struct.pack(
        "<IHHIIHH",
        16,
        fmt_tag,
        channel_count,
        sampling_rate,
        byte_rate,
        block_align,
        bits,
    )
    out += b"data" + struct.pack("<I", data_size)

    # interleave: stack channels as columns, row-major flatten
    if channel_count:
        interleaved = np.stack(pcm.channels, axis=1)
        if pcm.kind is PcmKind.I16:
            out += interleaved.astype("<i2").tobytes()
        elif pcm.kind is PcmKind.I32:
            out += interleaved.astype("<i4").tobytes()
        else:
            out += interleaved.astype("<f4").tobytes()
    return bytes(out)


def parse_wav(data: bytes) -> AudioData:
    """One-shot convenience: parse a whole WAV buffer into one AudioData."""
    proc = WavStreamProcessor()
    first = proc.add(data)
    if first is None:
        raise WavStreamError("incomplete WAV buffer")
    chunks = [first.data]
    while True:
        more = proc.add(b"")
        if more is None:
            break
        chunks.append(more.data)
    return AudioData(
        bits_per_sample=first.bits_per_sample,
        channel_count=first.channel_count,
        sampling_rate=first.sampling_rate,
        data=b"".join(chunks),
        audio_format=first.audio_format,
        endianness=first.endianness,
    )
