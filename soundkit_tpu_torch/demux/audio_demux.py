"""Container-only audio track demuxer (no codec decode).

Behavioral equivalent of ``soundkit-audio-demux``'s
``AudioTrackDemuxer`` (src/lib.rs:103-142): MP4 / WebM / MPEG-TS
autodetection with the 8 KiB min / 64 KiB max detection window
(:4-5), emitting ``AudioTrackConfig`` followed by
``AudioTrackPacket`` events.
"""
from __future__ import annotations

import enum
import struct
from dataclasses import dataclass, field
from typing import List, Optional, Union

from soundkit_tpu_torch.demux.ebml import WebmAudioDemuxer
from soundkit_tpu_torch.demux.latm import LatmError, LoasDemuxer
from soundkit_tpu_torch.demux.mp4 import Mp4Error, demux_mp4_audio
from soundkit_tpu_torch.demux.mpegts import MpegTsAudioDemuxer

MIN_DETECTION_BYTES = 8192
MAX_DETECTION_BYTES = 65536


class AudioContainer(enum.Enum):
    MP4 = "mp4"
    WEBM = "webm"
    MPEG_TS = "mpeg-ts"


class AudioCodec(enum.Enum):
    AAC = "aac"
    OPUS = "opus"
    VORBIS = "vorbis"
    MP3 = "mp3"
    AC3 = "ac3"
    ALAC = "alac"
    UNKNOWN = "unknown"


class AudioPacketFormat(enum.Enum):
    ADTS = "adts"
    LATM = "latm"
    RAW = "raw"


@dataclass
class AudioTrackConfig:
    container: AudioContainer
    codec: AudioCodec
    packet_format: Optional[AudioPacketFormat] = None
    codec_id: Optional[str] = None
    track_id: Optional[int] = None
    pid: Optional[int] = None
    stream_type: Optional[int] = None
    sample_rate: Optional[int] = None
    channels: Optional[int] = None
    sample_count: Optional[int] = None
    codec_private: bytes = b""
    pre_skip: Optional[int] = None
    output_gain: Optional[int] = None
    mapping_family: Optional[int] = None


@dataclass
class AudioTrackPacket:
    container: AudioContainer
    codec: AudioCodec
    format: AudioPacketFormat
    data: bytes
    track_id: Optional[int] = None
    pid: Optional[int] = None
    stream_type: Optional[int] = None
    sample_id: Optional[int] = None
    start_time: Optional[int] = None


AudioDemuxEvent = Union[AudioTrackConfig, AudioTrackPacket]


class AudioDemuxError(ValueError):
    pass


def _detect_container(buf: bytes) -> Optional[AudioContainer]:
    if len(buf) >= 12 and buf[4:8] == b"ftyp":
        return AudioContainer.MP4
    if buf[:4] == b"\x1a\x45\xdf\xa3":
        return AudioContainer.WEBM
    if len(buf) >= 188 * 2 and buf[0] == 0x47 and buf[188] == 0x47:
        return AudioContainer.MPEG_TS
    return None


_WEBM_CODECS = {
    "A_OPUS": AudioCodec.OPUS,
    "A_VORBIS": AudioCodec.VORBIS,
    "A_AAC": AudioCodec.AAC,
    "A_MPEG/L3": AudioCodec.MP3,
    "A_AC3": AudioCodec.AC3,
}


class AudioTrackDemuxer:
    def __init__(self, container: Optional[AudioContainer] = None):
        self._container = container
        self._detect_buf = bytearray()
        self._webm: Optional[WebmAudioDemuxer] = None
        self._ts: Optional[MpegTsAudioDemuxer] = None
        self._mp4_buf = bytearray()
        self._config_sent = False
        self._sample_id = 0
        self._finished = False
        # LATM elementary streams: parse LOAS down to raw AUs (beyond
        # the reference, which passes LATM PES payloads through —
        # soundkit-audio-demux/src/lib.rs:2249). Raw payloads are held
        # until the first AudioMuxElement parses, so a stream that
        # never syncs falls back to reference-parity passthrough.
        self._loas: Optional[LoasDemuxer] = None
        self._loas_pending: list = []
        self._loas_passthrough = False

    @classmethod
    def new_auto(cls) -> "AudioTrackDemuxer":
        return cls()

    @classmethod
    def new_with_format(cls, fmt: str) -> "AudioTrackDemuxer":
        try:
            return cls(AudioContainer(fmt))
        except ValueError:
            raise AudioDemuxError(f"unknown container format {fmt!r}")

    def push(self, data: bytes) -> List[AudioDemuxEvent]:
        if self._finished:
            return []
        if self._container is None:
            self._detect_buf.extend(data)
            if len(self._detect_buf) < 12:
                return []
            detected = _detect_container(bytes(self._detect_buf[:MAX_DETECTION_BYTES]))
            if detected is None:
                if len(self._detect_buf) >= MAX_DETECTION_BYTES:
                    raise AudioDemuxError("failed to detect container format")
                return []
            self._container = detected
            data = bytes(self._detect_buf)
            self._detect_buf.clear()
        return self._dispatch(data)

    def flush(self) -> List[AudioDemuxEvent]:
        self._finished = True
        if self._container == AudioContainer.MP4:
            return self._flush_mp4()
        if self._container == AudioContainer.MPEG_TS and self._ts is not None:
            events = self._emit_ts_packets(self._ts.flush())
            if self._loas_pending and not self._loas_passthrough:
                # stream ended before any AudioMuxElement parsed:
                # reference-parity passthrough of the raw PES payloads
                self._loas_passthrough = True
                events += self._emit_ts_packets([])
            return events
        if self._container is None and self._detect_buf:
            # small complete file: one last detection attempt
            detected = _detect_container(bytes(self._detect_buf))
            if detected is None:
                raise AudioDemuxError("failed to detect container format")
            self._container = detected
            events = self._dispatch(bytes(self._detect_buf))
            self._detect_buf.clear()
            if detected == AudioContainer.MP4:
                events += self._flush_mp4()
            return events
        return []

    # -- per-container --

    def _dispatch(self, data: bytes) -> List[AudioDemuxEvent]:
        if self._container == AudioContainer.MP4:
            self._mp4_buf.extend(data)
            return []
        if self._container == AudioContainer.WEBM:
            if self._webm is None:
                self._webm = WebmAudioDemuxer()
            packets = self._webm.push(data)
            events: List[AudioDemuxEvent] = []
            tr = self._webm.track
            if tr is not None and not self._config_sent:
                codec = _WEBM_CODECS.get(tr.codec_id, AudioCodec.UNKNOWN)
                cfg = AudioTrackConfig(
                    container=AudioContainer.WEBM,
                    codec=codec,
                    packet_format=AudioPacketFormat.RAW,
                    codec_id=tr.codec_id,
                    track_id=tr.number,
                    sample_rate=int(tr.sample_rate) or None,
                    channels=tr.channels,
                    codec_private=tr.codec_private,
                )
                if codec == AudioCodec.OPUS and len(tr.codec_private) >= 19:
                    cfg.pre_skip = struct.unpack_from("<H", tr.codec_private, 10)[0]
                    cfg.output_gain = struct.unpack_from("<h", tr.codec_private, 16)[0]
                    cfg.mapping_family = tr.codec_private[18]
                events.append(cfg)
                self._config_sent = True
            for p in packets:
                self._sample_id += 1
                events.append(
                    AudioTrackPacket(
                        container=AudioContainer.WEBM,
                        codec=_WEBM_CODECS.get(
                            self._webm.track.codec_id, AudioCodec.UNKNOWN
                        ) if self._webm.track else AudioCodec.UNKNOWN,
                        format=AudioPacketFormat.RAW,
                        data=p,
                        track_id=self._webm.track.number if self._webm.track else None,
                        sample_id=self._sample_id,
                    )
                )
            return events
        if self._container == AudioContainer.MPEG_TS:
            if self._ts is None:
                self._ts = MpegTsAudioDemuxer()
            return self._emit_ts_packets(self._ts.push(data))
        raise AudioDemuxError("no container configured")

    def _emit_ts_packets(self, pes) -> List[AudioDemuxEvent]:
        """Emit config + packet events for assembled PES payloads.

        ADTS/raw tracks pass the payload through (reference parity).
        LATM tracks are parsed down to raw access units via LOAS
        (see latm.py); if the elementary stream never produces a
        parseable AudioMuxElement, the raw payloads held so far are
        re-emitted passthrough-style like the reference.
        """
        events: List[AudioDemuxEvent] = []
        tr = self._ts.track
        if tr is None:
            return events
        latm = tr.packet_format == "latm" and not self._loas_passthrough
        if not latm:
            if not self._config_sent:
                events.append(
                    AudioTrackConfig(
                        container=AudioContainer.MPEG_TS,
                        codec=AudioCodec(tr.codec),
                        packet_format=AudioPacketFormat(tr.packet_format)
                        if tr.packet_format != "raw"
                        else AudioPacketFormat.RAW,
                        pid=tr.pid,
                        stream_type=tr.stream_type,
                    )
                )
                self._config_sent = True
            for data, pts in self._loas_pending:
                events.append(self._ts_raw_packet(data, pts))
            self._loas_pending.clear()
            events.extend(self._ts_packet(p) for p in pes)
            return events
        if self._loas is None:
            self._loas = LoasDemuxer()
        for p in pes:
            self._loas_pending.append((p.data, p.pts))
            try:
                aus = self._loas.push(p.data)
            except LatmError:
                self._loas_passthrough = True
                return events + self._emit_ts_packets([])
            if self._loas.frames:
                self._loas_pending.clear()
            if aus and not self._config_sent:
                cfg = self._loas.config
                events.append(
                    AudioTrackConfig(
                        container=AudioContainer.MPEG_TS,
                        codec=AudioCodec(tr.codec),
                        packet_format=AudioPacketFormat.LATM,
                        pid=tr.pid,
                        stream_type=tr.stream_type,
                        sample_rate=cfg.asc.sample_rate,
                        channels=cfg.asc.channels,
                        codec_private=cfg.asc.to_bytes(),
                    )
                )
                self._config_sent = True
            for au in aus:
                self._sample_id += 1
                events.append(
                    AudioTrackPacket(
                        container=AudioContainer.MPEG_TS,
                        codec=AudioCodec(tr.codec),
                        format=AudioPacketFormat.RAW,
                        data=au,
                        pid=tr.pid,
                        stream_type=tr.stream_type,
                        sample_id=self._sample_id,
                        start_time=p.pts,
                    )
                )
        pending_bytes = sum(len(d) for d, _ in self._loas_pending)
        if not self._loas.frames and pending_bytes > MAX_DETECTION_BYTES:
            self._loas_passthrough = True
            return events + self._emit_ts_packets([])
        return events

    def _ts_raw_packet(self, data: bytes, pts) -> AudioTrackPacket:
        tr = self._ts.track
        self._sample_id += 1
        return AudioTrackPacket(
            container=AudioContainer.MPEG_TS,
            codec=AudioCodec(tr.codec),
            format=AudioPacketFormat(tr.packet_format)
            if tr.packet_format != "raw"
            else AudioPacketFormat.RAW,
            data=data,
            pid=tr.pid,
            stream_type=tr.stream_type,
            sample_id=self._sample_id,
            start_time=pts,
        )

    def _ts_packet(self, p) -> AudioTrackPacket:
        return self._ts_raw_packet(p.data, p.pts)

    def _flush_mp4(self) -> List[AudioDemuxEvent]:
        if not self._mp4_buf:
            return []
        try:
            track = demux_mp4_audio(bytes(self._mp4_buf))
        except Mp4Error as e:
            raise AudioDemuxError(str(e))
        self._mp4_buf.clear()
        codec = {"aac": AudioCodec.AAC, "alac": AudioCodec.ALAC}.get(
            track.codec, AudioCodec.UNKNOWN
        )
        events: List[AudioDemuxEvent] = [
            AudioTrackConfig(
                container=AudioContainer.MP4,
                codec=codec,
                packet_format=AudioPacketFormat.RAW,
                sample_rate=track.sample_rate or None,
                channels=track.channels or None,
                sample_count=len(track.samples),
                codec_private=track.config,
            )
        ]
        for i, s in enumerate(track.samples):
            events.append(
                AudioTrackPacket(
                    container=AudioContainer.MP4,
                    codec=codec,
                    format=AudioPacketFormat.RAW,
                    data=s,
                    sample_id=i,
                )
            )
        return events
