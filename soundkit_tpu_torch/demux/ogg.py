"""Incremental Ogg page parser and packet assembler: ``OggPage``,
``OggPageParser`` and ``OggPacketizer`` of the JAX package's
``demux/ogg.py``, copied verbatim (chunk-boundary-agnostic page sync,
segment-table packet assembly with 255-lacing continuation across
pages), and the page writer ``build_ogg_page`` with its CRC, which the
smoke and the fixture tools build Ogg streams with. The Opus stream
writer ``OggOpusWriter`` is not ported.
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


def _ogg_crc_table():
    table = []
    for i in range(256):
        crc = i << 24
        for _ in range(8):
            crc = ((crc << 1) ^ 0x04C11DB7) & 0xFFFFFFFF \
                if crc & 0x80000000 else (crc << 1) & 0xFFFFFFFF
        table.append(crc)
    return table


_OGG_CRC_TABLE = _ogg_crc_table()


def _ogg_crc(data: bytes) -> int:
    """Ogg page CRC-32 (poly 0x04C11DB7, no reflection, init 0)."""
    crc = 0
    tab = _OGG_CRC_TABLE
    for b in data:
        crc = ((crc << 8) & 0xFFFFFFFF) ^ tab[((crc >> 24) ^ b) & 0xFF]
    return crc


def build_ogg_page(packets, serial: int, seq: int, granule: int,
                   header_type: int = 0) -> bytes:
    """One Ogg page from whole packets (RFC 3533 framing: 255-run
    segment lacing, little-endian header, CRC over the full page)."""
    import struct

    segs = bytearray()
    body = bytearray()
    for pkt in packets:
        n = len(pkt)
        while n >= 255:
            segs.append(255)
            n -= 255
        segs.append(n)
        body.extend(pkt)
    hdr = struct.pack("<4sBBqIII", b"OggS", 0, header_type, granule,
                      serial, seq, 0) + bytes([len(segs)]) + bytes(segs)
    page = bytearray(hdr + bytes(body))
    page[22:26] = struct.pack("<I", _ogg_crc(bytes(page)))
    return bytes(page)
