"""Incremental Ogg page parser and packet assembler: ``OggPage``,
``OggPageParser`` and ``OggPacketizer`` of the JAX package's
``demux/ogg.py``, copied verbatim (chunk-boundary-agnostic page sync,
segment-table packet assembly with 255-lacing continuation across
pages). The page writer is not ported.
"""
from __future__ import annotations

import struct
from typing import List, Optional, Tuple


class OggPage:
    __slots__ = ("header_type", "granule", "serial", "seq", "segments")

    def __init__(self, header_type: int, granule: int, serial: int, seq: int,
                 segments: List[Tuple[bytes, bool]]):
        self.header_type = header_type
        self.granule = granule
        self.serial = serial
        self.seq = seq
        # segments grouped into lacing units: (data, is_complete_packet_end)
        self.segments = segments


class OggPageParser:
    """Feed bytes, iterate complete pages."""

    def __init__(self) -> None:
        self._buf = bytearray()

    def push(self, data: bytes) -> List[OggPage]:
        self._buf.extend(data)
        pages = []
        while True:
            page = self._try_parse()
            if page is None:
                break
            pages.append(page)
        return pages

    def _try_parse(self) -> Optional[OggPage]:
        buf = self._buf
        # resync to capture pattern
        idx = buf.find(b"OggS")
        if idx < 0:
            # keep last 3 bytes in case the pattern is split
            if len(buf) > 3:
                del buf[:-3]
            return None
        if idx > 0:
            del buf[:idx]
        if len(buf) < 27:
            return None
        header_type = buf[5]
        granule = struct.unpack_from("<q", buf, 6)[0]
        serial = struct.unpack_from("<I", buf, 14)[0]
        seq = struct.unpack_from("<I", buf, 18)[0]
        nsegs = buf[26]
        if len(buf) < 27 + nsegs:
            return None
        seg_table = bytes(buf[27 : 27 + nsegs])
        body_len = sum(seg_table)
        total = 27 + nsegs + body_len
        if len(buf) < total:
            return None
        body = bytes(buf[27 + nsegs : total])
        del buf[:total]

        segments: List[Tuple[bytes, bool]] = []
        off = 0
        for lace in seg_table:
            segments.append((body[off : off + lace], lace < 255))
            off += lace
        return OggPage(header_type, granule, serial, seq, segments)


class OggPacketizer:
    """Assemble packets from pages (continuation across pages)."""

    def __init__(self) -> None:
        self._pages = OggPageParser()
        self._partial = bytearray()

    def push(self, data: bytes) -> List[Tuple[bytes, int]]:
        """Returns list of (packet, granule_of_its_page)."""
        packets = []
        for page in self._pages.push(data):
            if not (page.header_type & 0x01):  # not a continuation page
                # a fresh page while a partial packet is pending means the
                # stream dropped a page; discard the partial
                if self._partial and page.seq == 0:
                    self._partial.clear()
            for seg, ends in page.segments:
                self._partial.extend(seg)
                if ends:
                    packets.append((bytes(self._partial), page.granule))
                    self._partial.clear()
        return packets
