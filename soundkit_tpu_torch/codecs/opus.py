"""Ogg Opus framing of the JAX package's ``codecs/opus.py``, copied
verbatim: :class:`OpusHead` and :class:`OggOpusDemuxer` (config and
packet events over ``demux/ogg.OggPacketizer``). The packet decoders of
that module (``_OpusCore``, ``OggOpusDecoder``, ``OpusStreamDecoder``)
open FFmpeg and are not ported.
"""
from __future__ import annotations

import struct
from dataclasses import dataclass
from typing import List, Optional

from soundkit_tpu_torch.demux.ogg import OggPacketizer


@dataclass(frozen=True)
class OpusHead:
    version: int
    channels: int
    pre_skip: int
    input_sample_rate: int
    output_gain: int
    mapping_family: int
    raw: bytes

    @classmethod
    def parse(cls, data: bytes) -> "OpusHead":
        if len(data) < 19 or data[:8] != b"OpusHead":
            raise ValueError("not an OpusHead")
        return cls(
            version=data[8],
            channels=data[9],
            pre_skip=struct.unpack_from("<H", data, 10)[0],
            input_sample_rate=struct.unpack_from("<I", data, 12)[0],
            output_gain=struct.unpack_from("<h", data, 16)[0],
            mapping_family=data[18],
            raw=bytes(data),
        )


class OggOpusDemuxer:
    """Config/packet event demuxer (soundkit-ogg-opus/src/lib.rs:193)."""

    def __init__(self) -> None:
        self._pkts = OggPacketizer()
        self.head: Optional[OpusHead] = None
        self._tags_skipped = False

    def push(self, data: bytes) -> List[bytes]:
        """Returns raw Opus packets; populates .head on config."""
        out = []
        for packet, _granule in self._pkts.push(data):
            if self.head is None:
                self.head = OpusHead.parse(packet)
                continue
            if not self._tags_skipped:
                self._tags_skipped = True  # OpusTags
                continue
            out.append(packet)
        return out
