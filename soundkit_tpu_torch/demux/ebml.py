"""Incremental EBML/Matroska (WebM) audio demuxer.

Behavioral equivalent of the reference's own WebM layer
(soundkit-webm/src/lib.rs): VINT reader (:36), element IDs (:15-30),
Opus demuxer (:354), codec-agnostic ``WebmAudioDemuxer`` (:739) and
decoding ``WebmDecoder`` for Opus or Vorbis tracks (:1125).

Emits (codec_id, codec_private, sample_rate, channels) config plus
per-block packets from SimpleBlocks/BlockGroups.
"""
from __future__ import annotations

import struct
from dataclasses import dataclass
from typing import List, Optional, Tuple

# Element IDs (matroska)
EBML_HEADER = 0x1A45DFA3
SEGMENT = 0x18538067
TRACKS = 0x1654AE6B
TRACK_ENTRY = 0xAE
TRACK_NUMBER = 0xD7
TRACK_TYPE = 0x83
CODEC_ID = 0x86
CODEC_PRIVATE = 0x63A2
AUDIO = 0xE1
SAMPLING_FREQUENCY = 0xB5
CHANNELS = 0x9F
CLUSTER = 0x1F43B675
TIMESTAMP = 0xE7
SIMPLE_BLOCK = 0xA3
BLOCK_GROUP = 0xA0
BLOCK = 0xA1

_MASTER = {SEGMENT, TRACKS, TRACK_ENTRY, AUDIO, CLUSTER, BLOCK_GROUP}


def read_vint(data: bytes, pos: int) -> Optional[Tuple[int, int, int]]:
    """Returns (value_with_marker_stripped, width, raw_value) or None."""
    if pos >= len(data):
        return None
    b0 = data[pos]
    if b0 == 0:
        return None
    width = 0
    mask = 0x80
    while not (b0 & mask):
        mask >>= 1
        width += 1
    width += 1
    if pos + width > len(data):
        return None
    raw = 0
    for i in range(width):
        raw = (raw << 8) | data[pos + i]
    stripped = raw & ~(mask << (8 * (width - 1)))
    return stripped, width, raw


@dataclass
class WebmTrack:
    number: int
    codec_id: str
    codec_private: bytes
    sample_rate: float
    channels: int


class WebmAudioDemuxer:
    """Incremental: push bytes, collect audio track config + packets."""

    def __init__(self) -> None:
        self._buf = bytearray()
        self._pos = 0  # absolute offset of buf[0]
        self.track: Optional[WebmTrack] = None
        self._packets: List[bytes] = []
        # parse state: we walk top-level/known master elements lazily
        self._scan = 0  # offset into buf of next unparsed byte

    def push(self, data: bytes) -> List[bytes]:
        self._buf.extend(data)
        self._parse()
        out, self._packets = self._packets, []
        return out

    # -- internals --

    def _parse(self) -> None:
        buf = self._buf
        pos = self._scan
        while True:
            el = self._read_element_header(buf, pos)
            if el is None:
                break
            eid, size, hdr, unknown_size = el
            body_start = pos + hdr
            if eid == TRACKS:
                # tracks are small: require the whole body then parse
                if size >= 0 and len(buf) >= body_start + size:
                    self._parse_tracks(bytes(buf[body_start : body_start + size]))
                    pos = body_start + size
                    continue
                break  # wait at the element START for the complete body
            if eid in _MASTER or unknown_size:
                # descend into master elements without requiring full body
                pos = body_start
                continue
            if size < 0 or len(buf) < body_start + size:
                break  # incomplete element
            body = bytes(buf[body_start : body_start + size])
            if eid == SIMPLE_BLOCK or eid == BLOCK:
                self._handle_block(body)
            pos = body_start + size
        self._scan = pos
        # compact
        if self._scan > (1 << 20):
            del self._buf[: self._scan]
            self._scan = 0

    @staticmethod
    def _read_element_header(buf, pos) -> Optional[Tuple[int, int, int, bool]]:
        vid = read_vint(buf, pos)
        if vid is None:
            return None
        _, id_w, raw_id = vid
        vsz = read_vint(buf, pos + id_w)
        if vsz is None:
            return None
        sz, sz_w, raw_sz = vsz
        unknown = sz == (1 << (7 * sz_w)) - 1
        return raw_id, (-1 if unknown else sz), id_w + sz_w, unknown

    def _parse_tracks(self, body: bytes) -> None:
        pos = 0
        while pos < len(body):
            el = self._read_element_header(body, pos)
            if el is None:
                break
            eid, size, hdr, _ = el
            if size < 0:
                break
            if eid == TRACK_ENTRY:
                tr = self._parse_track_entry(body[pos + hdr : pos + hdr + size])
                if tr is not None and self.track is None:
                    self.track = tr
            pos += hdr + size

    def _parse_track_entry(self, body: bytes) -> Optional[WebmTrack]:
        pos = 0
        number = 0
        ttype = 0
        codec_id = ""
        private = b""
        rate = 0.0
        channels = 1
        while pos < len(body):
            el = self._read_element_header(body, pos)
            if el is None:
                break
            eid, size, hdr, _ = el
            if size < 0:
                break
            val = body[pos + hdr : pos + hdr + size]
            if eid == TRACK_NUMBER:
                number = int.from_bytes(val, "big")
            elif eid == TRACK_TYPE:
                ttype = int.from_bytes(val, "big")
            elif eid == CODEC_ID:
                codec_id = val.decode("ascii", "replace")
            elif eid == CODEC_PRIVATE:
                private = val
            elif eid == AUDIO:
                apos = 0
                while apos < len(val):
                    ael = self._read_element_header(val, apos)
                    if ael is None:
                        break
                    aid, asize, ahdr, _ = ael
                    av = val[apos + ahdr : apos + ahdr + asize]
                    if aid == SAMPLING_FREQUENCY:
                        rate = struct.unpack(">f" if asize == 4 else ">d", av)[0]
                    elif aid == CHANNELS:
                        channels = int.from_bytes(av, "big")
                    apos += ahdr + asize
            pos += hdr + size
        if ttype == 2:  # audio
            return WebmTrack(number, codec_id, private, rate, channels)
        return None

    def _handle_block(self, body: bytes) -> None:
        v = read_vint(body, 0)
        if v is None:
            return
        track_num, w, _ = v
        if self.track is not None and track_num != self.track.number:
            return
        # int16 timestamp + flags byte
        if len(body) < w + 3:
            return
        flags = body[w + 2]
        payload = body[w + 3 :]
        lacing = (flags >> 1) & 0x3
        if lacing == 0:
            self._packets.append(payload)
            return
        # laced frames
        if not payload:
            return
        nframes = payload[0] + 1
        pos = 1
        sizes: List[int] = []
        if lacing == 2:  # fixed
            each = (len(payload) - 1) // nframes
            sizes = [each] * nframes
        elif lacing == 1:  # Xiph
            for _ in range(nframes - 1):
                s = 0
                while pos < len(payload):
                    s += payload[pos]
                    if payload[pos] != 255:
                        pos += 1
                        break
                    pos += 1
                sizes.append(s)
            sizes.append(len(payload) - pos - sum(sizes))
        else:  # EBML lacing
            v = read_vint(payload, pos)
            if v is None:
                return
            first, vw, _ = v
            pos += vw
            sizes.append(first)
            prev = first
            for _ in range(nframes - 2):
                v = read_vint(payload, pos)
                if v is None:
                    return
                delta, vw, _ = v
                pos += vw
                # signed delta
                delta -= (1 << (7 * vw - 1)) - 1
                prev += delta
                sizes.append(prev)
            sizes.append(len(payload) - pos - sum(sizes))
        for s in sizes:
            if s <= 0 or pos + s > len(payload):
                return
            self._packets.append(payload[pos : pos + s])
            pos += s
