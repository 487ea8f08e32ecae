"""SoundKit frame header wire formats (v1 and v2).

The reference consumes the external ``frame-header`` crate; its wire
format is not vendored there, so this module *re-specifies* the two
header versions with the same field sets and usage contracts observed
in the reference (soundkit/src/audio_packet.rs:34-53,151-162 for v1;
soundkit/src/frame_stream.rs:79-122 for v2):

v1 (audio packets; ``size() <= 20``):
  byte 0      encoding(3 bits, MSB-first) | 0x10 has_id | 0x08 big-endian
  bytes 1:3   sample_size  u16 BE (frame length in samples)
  bytes 3:7   sample_rate  u32 BE
  byte 7      channels
  byte 8      bits_per_sample
  [bytes 9:17 id u64 BE when has_id]
The 3-bit encoding flag sits in the top bits of the first big-endian
u32, satisfying ``get_encoding_flag`` (audio_packet.rs:40-43).

v2 (length-prefixed transport frames; ``BASE_SIZE = 15``):
  byte 0      magic 0xA2
  byte 1      encoding(3) << 5 | endianness << 4
  byte 2      packet flags (0x01 ENCRYPTED, 0x02 HAS_ID,
              0x04 HAS_BITRATE, 0x08 HAS_CRC32)
  byte 3      channels
  byte 4      bits_per_sample
  bytes 5:9   payload_size u32 BE
  bytes 9:13  sample_rate  u32 BE
  bytes 13:15 sample_size  u16 BE
  [id u64 BE][bitrate u32 BE][packet_crc32 u32 BE]  (flag-gated, in order)
``header_size(buffer)`` is computable from the BASE_SIZE prefix alone.
"""
from __future__ import annotations

import struct
import zlib
from dataclasses import dataclass, replace
from typing import Optional

from soundkit_tpu_torch.core.audio_types import EncodingFlag, Endianness


class FrameHeaderError(ValueError):
    pass


@dataclass(frozen=True)
class FrameHeader:
    """v1 header."""

    encoding: EncodingFlag
    sample_size: int
    sample_rate: int
    channels: int
    bits_per_sample: int
    endianness: Endianness = Endianness.LITTLE
    id: Optional[int] = None

    def size(self) -> int:
        return 9 + (8 if self.id is not None else 0)

    def encode(self) -> bytes:
        if not 0 <= self.sample_size <= 0xFFFF:
            raise FrameHeaderError("sample_size out of range")
        b0 = (int(self.encoding) << 5) | (0x10 if self.id is not None else 0)
        if self.endianness == Endianness.BIG:
            b0 |= 0x08
        out = struct.pack(
            ">BHIBB",
            b0,
            self.sample_size,
            self.sample_rate,
            self.channels,
            self.bits_per_sample,
        )
        if self.id is not None:
            out += struct.pack(">Q", self.id)
        return out

    @classmethod
    def decode(cls, data: bytes) -> "FrameHeader":
        if len(data) < 9:
            raise FrameHeaderError("v1 header too short")
        b0, sample_size, rate, channels, bits = struct.unpack_from(">BHIBB", data)
        has_id = bool(b0 & 0x10)
        if has_id and len(data) < 17:
            raise FrameHeaderError("v1 header too short for id")
        return cls(
            encoding=EncodingFlag((b0 >> 5) & 0x7),
            sample_size=sample_size,
            sample_rate=rate,
            channels=channels,
            bits_per_sample=bits,
            endianness=Endianness.BIG if b0 & 0x08 else Endianness.LITTLE,
            id=struct.unpack_from(">Q", data, 9)[0] if has_id else None,
        )


def get_encoding_flag(header_bytes: bytes) -> EncodingFlag:
    """Top 3 bits of the first BE u32 (audio_packet.rs:34-53)."""
    if len(header_bytes) < 4:
        raise FrameHeaderError("Header too small to extract encoding flag")
    word = struct.unpack_from(">I", header_bytes)[0]
    code = (word >> 29) & 0x7
    if code > 4:
        raise FrameHeaderError("Unknown encoding flag")
    return EncodingFlag(code)


V2_MAGIC = 0xA2
V2_BASE_SIZE = 15

FLAG_ENCRYPTED = 0x01
FLAG_HAS_ID = 0x02
FLAG_HAS_BITRATE = 0x04
FLAG_HAS_CRC32 = 0x08


@dataclass(frozen=True)
class FrameHeaderV2:
    encoding: EncodingFlag
    payload_size: int
    sample_size: int
    sample_rate: int
    channels: int
    bits_per_sample: int
    endianness: Endianness = Endianness.LITTLE
    id: Optional[int] = None
    bitrate: Optional[int] = None
    packet_flags: int = 0
    packet_crc32: Optional[int] = None

    BASE_SIZE = V2_BASE_SIZE
    FLAG_ENCRYPTED = FLAG_ENCRYPTED

    def _flags(self) -> int:
        flags = self.packet_flags & ~(FLAG_HAS_ID | FLAG_HAS_BITRATE | FLAG_HAS_CRC32)
        if self.id is not None:
            flags |= FLAG_HAS_ID
        if self.bitrate is not None:
            flags |= FLAG_HAS_BITRATE
        if self.packet_crc32 is not None:
            flags |= FLAG_HAS_CRC32
        return flags

    @property
    def is_encrypted(self) -> bool:
        return bool(self.packet_flags & FLAG_ENCRYPTED)

    def with_packet_flags(self, flags: int) -> "FrameHeaderV2":
        return replace(self, packet_flags=flags)

    def with_packet_crc32(self, payload: bytes) -> "FrameHeaderV2":
        return replace(self, packet_crc32=zlib.crc32(payload) & 0xFFFFFFFF)

    def verify_packet_crc32(self, payload: bytes) -> bool:
        if self.packet_crc32 is None:
            return True
        return (zlib.crc32(payload) & 0xFFFFFFFF) == self.packet_crc32

    def size(self) -> int:
        return (
            V2_BASE_SIZE
            + (8 if self.id is not None else 0)
            + (4 if self.bitrate is not None else 0)
            + (4 if self.packet_crc32 is not None else 0)
        )

    def encode(self) -> bytes:
        b1 = (int(self.encoding) << 5) | (
            0x10 if self.endianness == Endianness.BIG else 0
        )
        out = struct.pack(
            ">BBBBBIIH",
            V2_MAGIC,
            b1,
            self._flags(),
            self.channels,
            self.bits_per_sample,
            self.payload_size,
            self.sample_rate,
            self.sample_size,
        )
        if self.id is not None:
            out += struct.pack(">Q", self.id)
        if self.bitrate is not None:
            out += struct.pack(">I", self.bitrate)
        if self.packet_crc32 is not None:
            out += struct.pack(">I", self.packet_crc32)
        return out

    @staticmethod
    def header_size(buffer: bytes) -> int:
        """Total header size from the BASE_SIZE prefix."""
        if len(buffer) < V2_BASE_SIZE:
            raise FrameHeaderError("v2 header prefix too short")
        if buffer[0] != V2_MAGIC:
            raise FrameHeaderError("bad v2 magic")
        flags = buffer[2]
        return (
            V2_BASE_SIZE
            + (8 if flags & FLAG_HAS_ID else 0)
            + (4 if flags & FLAG_HAS_BITRATE else 0)
            + (4 if flags & FLAG_HAS_CRC32 else 0)
        )

    @classmethod
    def decode(cls, data: bytes) -> "FrameHeaderV2":
        total = cls.header_size(data)
        if len(data) < total:
            raise FrameHeaderError("v2 header too short")
        _, b1, flags, channels, bits, payload_size, rate, sample_size = struct.unpack_from(
            ">BBBBBIIH", data
        )
        pos = V2_BASE_SIZE
        fid = bitrate = crc = None
        if flags & FLAG_HAS_ID:
            fid = struct.unpack_from(">Q", data, pos)[0]
            pos += 8
        if flags & FLAG_HAS_BITRATE:
            bitrate = struct.unpack_from(">I", data, pos)[0]
            pos += 4
        if flags & FLAG_HAS_CRC32:
            crc = struct.unpack_from(">I", data, pos)[0]
            pos += 4
        return cls(
            encoding=EncodingFlag((b1 >> 5) & 0x7),
            payload_size=payload_size,
            sample_size=sample_size,
            sample_rate=rate,
            channels=channels,
            bits_per_sample=bits,
            endianness=Endianness.BIG if b1 & 0x10 else Endianness.LITTLE,
            id=fid,
            bitrate=bitrate,
            packet_flags=flags,
            packet_crc32=crc,
        )
