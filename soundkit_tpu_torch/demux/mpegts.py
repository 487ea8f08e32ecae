"""MPEG-TS audio demuxer.

Behavioral equivalent of the reference's MPEG-TS path in
``soundkit-audio-demux`` (soundkit-audio-demux/src/lib.rs:122):
188-byte packet sync, PAT -> PMT walk, audio elementary stream
selection by stream_type (0x0F ADTS AAC, 0x11 LATM, 0x03/0x04 MP3,
0x81 AC-3), PES assembly with PTS extraction.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

TS_PACKET = 188
SYNC = 0x47

AUDIO_STREAM_TYPES = {
    0x03: ("mp3", "raw"),
    0x04: ("mp3", "raw"),
    0x0F: ("aac", "adts"),
    0x11: ("aac", "latm"),
    0x81: ("ac3", "raw"),
}


@dataclass
class TsAudioTrack:
    pid: int
    stream_type: int
    codec: str
    packet_format: str


@dataclass
class TsPacket:
    data: bytes
    pts: Optional[int]


class MpegTsAudioDemuxer:
    def __init__(self) -> None:
        self._buf = bytearray()
        self._pmt_pids: List[int] = []
        self.track: Optional[TsAudioTrack] = None
        self._pes = bytearray()
        self._pes_pts: Optional[int] = None
        self._started = False

    def push(self, data: bytes) -> List[TsPacket]:
        self._buf.extend(data)
        out: List[TsPacket] = []
        while len(self._buf) >= TS_PACKET:
            if self._buf[0] != SYNC:
                # resync
                idx = self._buf.find(bytes([SYNC]))
                if idx < 0:
                    self._buf.clear()
                    break
                del self._buf[:idx]
                continue
            pkt = bytes(self._buf[:TS_PACKET])
            del self._buf[:TS_PACKET]
            out.extend(self._packet(pkt))
        return out

    def flush(self) -> List[TsPacket]:
        if self._pes and self.track is not None:
            pkt = TsPacket(bytes(self._pes), self._pes_pts)
            self._pes.clear()
            return [pkt]
        return []

    # -- internals --

    def _packet(self, pkt: bytes) -> List[TsPacket]:
        pid = ((pkt[1] & 0x1F) << 8) | pkt[2]
        pusi = bool(pkt[1] & 0x40)
        afc = (pkt[3] >> 4) & 0x3
        pos = 4
        if afc in (2, 3):
            af_len = pkt[4]
            pos = 5 + af_len
        if afc in (0, 2) or pos >= TS_PACKET:
            return []
        payload = pkt[pos:]

        if pid == 0:
            self._parse_pat(payload, pusi)
            return []
        if pid in self._pmt_pids:
            self._parse_pmt(payload, pusi)
            return []
        if self.track is not None and pid == self.track.pid:
            return self._feed_pes(payload, pusi)
        return []

    @staticmethod
    def _psi(payload: bytes, pusi: bool) -> Optional[bytes]:
        if not pusi or not payload:
            return None
        pointer = payload[0]
        return payload[1 + pointer :]

    def _parse_pat(self, payload: bytes, pusi: bool) -> None:
        sec = self._psi(payload, pusi)
        if not sec or len(sec) < 8 or sec[0] != 0x00:
            return
        length = ((sec[1] & 0x0F) << 8) | sec[2]
        data = sec[8 : 3 + length - 4]  # minus CRC
        for i in range(0, len(data) - 3, 4):
            prog = (data[i] << 8) | data[i + 1]
            pid = ((data[i + 2] & 0x1F) << 8) | data[i + 3]
            if prog != 0 and pid not in self._pmt_pids:
                self._pmt_pids.append(pid)

    def _parse_pmt(self, payload: bytes, pusi: bool) -> None:
        if self.track is not None:
            return
        sec = self._psi(payload, pusi)
        if not sec or len(sec) < 12 or sec[0] != 0x02:
            return
        length = ((sec[1] & 0x0F) << 8) | sec[2]
        pinfo_len = ((sec[10] & 0x0F) << 8) | sec[11]
        pos = 12 + pinfo_len
        end = 3 + length - 4
        while pos + 5 <= end:
            stype = sec[pos]
            epid = ((sec[pos + 1] & 0x1F) << 8) | sec[pos + 2]
            es_len = ((sec[pos + 3] & 0x0F) << 8) | sec[pos + 4]
            pos += 5 + es_len
            if stype in AUDIO_STREAM_TYPES:
                codec, fmt = AUDIO_STREAM_TYPES[stype]
                self.track = TsAudioTrack(epid, stype, codec, fmt)
                return

    def _feed_pes(self, payload: bytes, pusi: bool) -> List[TsPacket]:
        out: List[TsPacket] = []
        if pusi:
            if self._pes and self._started:
                out.append(TsPacket(bytes(self._pes), self._pes_pts))
            self._pes.clear()
            self._started = True
            # PES header: 00 00 01 sid len len flags flags hdr_len
            if len(payload) >= 9 and payload[:3] == b"\x00\x00\x01":
                hdr_len = payload[8]
                pts = None
                if payload[7] & 0x80 and len(payload) >= 14:
                    p = payload[9:14]
                    pts = (
                        ((p[0] >> 1) & 0x7) << 30
                        | p[1] << 22
                        | (p[2] >> 1) << 15
                        | p[3] << 7
                        | (p[4] >> 1)
                    )
                self._pes_pts = pts
                self._pes.extend(payload[9 + hdr_len :])
                return out
        if self._started:
            self._pes.extend(payload)
        return out
