"""Incremental Ogg page parser and packet assembler: ``OggPage``,
``OggPageParser`` and ``OggPacketizer`` of the JAX package's
``demux/ogg.py``, copied verbatim (chunk-boundary-agnostic page sync,
segment-table packet assembly with 255-lacing continuation across
pages), and the page writer ``build_ogg_page`` with its CRC, which the
smoke and the fixture tools build Ogg streams with, and the Opus stream
writer ``OggOpusWriter`` over it, also verbatim.
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


def _packet_samples_48k(packet: bytes) -> int:
    """48 kHz sample count of one Opus packet from its TOC byte."""
    from soundkit_tpu_torch.codecs.opus_core import parse_packet

    if not packet:
        return 0
    toc, frames = parse_packet(packet)
    return int(toc.frame_duration * 48) * max(len(frames), 1)


class OggOpusWriter:
    """Mux Opus packets into an Ogg-Opus stream (RFC 7845): OpusHead
    BOS page, OpusTags page, then one packet per page with 48 kHz
    granule positions and an EOS flag at close.

    The encode-direction sibling of OggOpusDemuxer — pair with the
    owned encoder (codecs/opus_celt_enc.OpusCeltEncoder) for a fully
    owned .opus-file pipeline.  No reference analog exists (its
    encoders emit raw packets only)."""

    def __init__(self, channels: int, pre_skip: int = 0,
                 input_sample_rate: int = 48000, output_gain: int = 0,
                 serial: int = 0x534B5401, vendor: bytes = b"soundkit-tpu"):
        import struct

        self._serial = serial
        self._seq = 0
        self._granule = 0
        self._pending: list = []
        self._closed = False
        head = (b"OpusHead" + bytes([1, channels])
                + struct.pack("<H", pre_skip)
                + struct.pack("<I", input_sample_rate)
                + struct.pack("<h", output_gain) + b"\x00")
        tags = (b"OpusTags" + struct.pack("<I", len(vendor)) + vendor
                + struct.pack("<I", 0))
        self._out = bytearray()
        self._out += build_ogg_page([head], serial, self._next_seq(), 0,
                                    header_type=2)  # BOS
        self._out += build_ogg_page([tags], serial, self._next_seq(), 0)

    def _next_seq(self) -> int:
        s = self._seq
        self._seq += 1
        return s

    def write_packet(self, packet: bytes,
                     samples_48k: int = 0) -> None:
        """Append one Opus packet.  The granule advances by the
        packet's own 48 kHz sample count, derived from its TOC byte
        (frame duration x frame count) unless ``samples_48k``
        overrides it."""
        if self._closed:
            raise ValueError("writer is closed")
        packet = bytes(packet)
        if samples_48k <= 0:
            samples_48k = _packet_samples_48k(packet)
        self._pending.append((packet, samples_48k))

    def take(self) -> bytes:
        """Drain the muxed bytes produced so far (streamable)."""
        for pkt, n in self._pending:
            self._granule += n
            self._out += build_ogg_page([pkt], self._serial,
                                        self._next_seq(), self._granule)
        self._pending = []
        out = bytes(self._out)
        self._out = bytearray()
        return out

    def close(self) -> bytes:
        """Flush with the EOS flag on the final page."""
        if self._closed:
            return b""
        self._closed = True
        if self._pending:
            *head_pkts, last = self._pending
            for pkt, n in head_pkts:
                self._granule += n
                self._out += build_ogg_page([pkt], self._serial,
                                            self._next_seq(),
                                            self._granule)
            pkt, n = last
            self._granule += n
            self._out += build_ogg_page([pkt], self._serial,
                                        self._next_seq(), self._granule,
                                        header_type=4)  # EOS
            self._pending = []
        else:
            # packet-free EOS page (zero segments): a zero-length
            # "packet" would reach the Opus layer and is invalid
            self._out += build_ogg_page([], self._serial,
                                        self._next_seq(), self._granule,
                                        header_type=4)
        out = bytes(self._out)
        self._out = bytearray()
        return out
