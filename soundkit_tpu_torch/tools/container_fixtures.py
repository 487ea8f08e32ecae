"""Container fixtures for the port's tests and ``chip_smoke.py``: M4A
AAC, LOAS/LATM, WebM (Opus and Vorbis) and MPEG-TS, each built at run
time by remuxing the packets of the in-repo clips (no encoder, no
download):

- ``m4a_aac``: the first :data:`AAC_UNITS` access units of the
  ``chords`` ADTS clip (48 kHz stereo AAC-LC) in an MP4
  (``host_codec_fixtures.mux_mp4("aac", ...)``, the AudioSpecificConfig
  in its ``esds``);
- ``latm_8`` / ``latm_1``: the same number of ``speech_like``'s access
  units as a LOAS AudioSyncStream (``demux/latm.mux_loas``), the
  StreamMuxConfig in every 8th / every AudioMuxElement;
- ``webm_vorbis``: ``stereo44``'s three header packets as the track's
  Xiph-laced ``CodecPrivate`` and its first :data:`VORBIS_PACKETS` audio
  packets, two a SimpleBlock (Xiph lacing), in known-size Segment and
  Clusters;
- ``webm_opus_celt``: ``stereo96``'s OpusHead and first
  :data:`OPUS_PACKETS` packets (20 ms CELT), one a SimpleBlock, known
  sizes; ``webm_opus_silk`` (``silk_wb``, mono SILK WB) and
  ``webm_opus_hybrid`` (``hybrid_fb``, stereo hybrid FB): the same in an
  unknown-size Segment and Clusters, the SILK one in BlockGroups;
- ``ts_adts`` / ``ts_latm`` / ``ts_mp3``: one program of three audio
  tracks over 188-byte packets (PAT and PMT repeated, a null packet, PES
  that span packets, the last packet of each padded by its adaptation
  field): an ADTS track (stream_type 0x0F, ``castanets``' frames), a
  LOAS/LATM track (0x11, ``drums``' units, config every 8th) and an
  MP3 track (0x03, the ``stereo44`` MP3 clip's frames), the PMT listing
  the named one first, which is the track the demuxer takes.

:func:`build` gives a case's bytes, :func:`units` the packets it was
made from, :func:`long_stream` a decodable case made at least some
seconds long by repeating its units (a long stream's decode begins with
the case's), :func:`event_records` / :func:`events_digest` a canonical
JSON form of ``AudioTrackDemuxer`` events.

``tests/data/torch_port/containers/index.json`` holds, for every case,
its route (``spawn``: detection, ``latm`` for ``spawn_aac_latm``, or
``demux`` for the MPEG-TS cases, which only the track demuxer reads),
the rate and channels, the length and SHA-256 of the int16 PCM that the
JAX package's owned decoders give for it (``AacLcStreamDecoder`` on the
access units, ``WebmAdapter`` for Vorbis, ``_OpusCore`` on the packets
with the same OpusHead), and the JAX package's ``AudioTrackDemuxer``
events (the config events in full, the number of events and the SHA-256
of all of them). ``reference_pcm.npz`` keeps the JAX package's PCM of
the first second of ``webm_opus_silk``, whose SILK resampler the port
replaces (held within 1 LSB, not by its hash). The index is written on
the test side (``tests/torch_port_helpers.py``; needs the JAX package),
from the repository's root::

    PYTHONPATH=. JAX_PLATFORMS=cpu python tests/torch_port_helpers.py containers
"""
from __future__ import annotations

import hashlib
import json
import math
import struct
from pathlib import Path
from typing import Dict, List, Sequence, Tuple

import numpy as np

FIXTURE_DIR = Path(__file__).resolve().parents[2] / "tests" / "data" / "torch_port" / "containers"

AAC_UNITS = 40        # access units of an AAC case (0.85 s at 48 kHz)
OPUS_PACKETS = 100    # packets of a WebM Opus case (2 s)
VORBIS_PACKETS = 170  # audio packets of the WebM Vorbis case (2.08 s at 44.1 kHz)
TS_UNITS = 40         # frames of each MPEG-TS track

M4A = ("m4a_aac",)
LATM = ("latm_8", "latm_1")
WEBM = ("webm_vorbis", "webm_opus_celt", "webm_opus_silk", "webm_opus_hybrid")
TS = ("ts_adts", "ts_latm", "ts_mp3")
CASES = M4A + LATM + WEBM + TS
#: the cases a decoder reads (the MPEG-TS ones are demuxed only)
DECODED = M4A + LATM + WEBM
#: the cases whose JAX PCM is committed (the first second), not only hashed
REFERENCE_PCM = ("webm_opus_silk",)

_OPUS_CLIP = {"webm_opus_celt": "stereo96", "webm_opus_silk": "silk_wb",
              "webm_opus_hybrid": "hybrid_fb"}
# the ADTS clip of each AAC use
_AAC_CLIP = {"m4a_aac": "chords", "latm": "speech_like", "ts_adts": "castanets",
             "ts_latm": "drums"}


def load_index(directory: Path = FIXTURE_DIR) -> Dict[str, dict]:
    return json.loads((directory / "index.json").read_text())


def reference_pcm(name: str, directory: Path = FIXTURE_DIR) -> np.ndarray:
    """The JAX package's int16 PCM of the first second of a case in
    :data:`REFERENCE_PCM`, interleaved."""
    with np.load(directory / "reference_pcm.npz") as z:
        return z[name]


def sha256(data: bytes) -> str:
    return hashlib.sha256(data).hexdigest()


# ---------------------------------------------------------------------------
# the packets
# ---------------------------------------------------------------------------

def adts_frames(clip: str, n: int) -> List[bytes]:
    """The first ``n`` ADTS frames (headers kept) of an AAC clip."""
    from soundkit_tpu_torch.tools import aac_fixtures as af

    return af.split_adts((af.FIXTURE_DIR / f"{clip}.aac").read_bytes())[:n]


def aac_units(clip: str, n: int) -> Tuple[bytes, List[bytes]]:
    """(AudioSpecificConfig, the first ``n`` raw access units) of an AAC
    clip: the ADTS headers stripped, the config built from the first."""
    from soundkit_tpu_torch.codecs.aac_lc import AdtsStream

    st = AdtsStream()
    aus = st.push(b"".join(adts_frames(clip, n)))
    sr, ch = st.sr_index, st.channel_config
    return bytes([(2 << 3) | (sr >> 1), ((sr & 1) << 7) | (ch << 3)]), aus


def _asc_info(asc: bytes):
    from soundkit_tpu_torch.demux.latm import parse_audio_specific_config

    return parse_audio_specific_config(asc)


def opus_units(name: str, n: int = OPUS_PACKETS) -> Tuple[bytes, List[bytes]]:
    """(OpusHead, the first ``n`` packets) of a WebM Opus case's clip."""
    from soundkit_tpu_torch.tools import opus_fixtures as of

    clip = of.load_clips(names=(_OPUS_CLIP[name],))[0]
    return clip.head, clip.packets[:n]


def vorbis_units(n: int = VORBIS_PACKETS) -> Tuple[List[bytes], List[bytes]]:
    """(the three header packets, the first ``n`` audio packets) of the
    ``stereo44`` Vorbis clip."""
    from soundkit_tpu_torch.demux.ogg import OggPacketizer
    from soundkit_tpu_torch.tools import vorbis_fixtures as vf

    packets = [p for p, _g in OggPacketizer().push(vf.load_clips(names=("stereo44",))[0].stream())]
    return packets[:3], packets[3:3 + n]


def mp3_frames(n: int = TS_UNITS) -> List[bytes]:
    from soundkit_tpu_torch.tools import mp3_fixtures as mf

    return {c.name: c for c in mf.load_clips()}["stereo44"].frames[:n]


def units(name: str):
    """(config, packets) a decodable case is made of: the AudioSpecificConfig
    and access units (M4A, LATM), the CodecPrivate and packets (WebM)."""
    if name in M4A:
        return aac_units(_AAC_CLIP["m4a_aac"], AAC_UNITS)
    if name in LATM:
        return aac_units(_AAC_CLIP["latm"], AAC_UNITS)
    if name == "webm_vorbis":
        from soundkit_tpu_torch.codecs.vorbis import xiph_extradata

        headers, packets = vorbis_units()
        return xiph_extradata(headers), packets
    if name in _OPUS_CLIP:
        return opus_units(name)
    raise ValueError(f"no units for {name!r}")


# ---------------------------------------------------------------------------
# WebM
# ---------------------------------------------------------------------------

_UNKNOWN = b"\x01\xff\xff\xff\xff\xff\xff\xff"


def _vint(n: int) -> bytes:
    """``n`` as an EBML size of the fewest bytes (all ones is reserved)."""
    w = 1
    while n >= (1 << (7 * w)) - 1:
        w += 1
    return ((1 << (7 * w)) | n).to_bytes(w, "big")


def _el(eid: int, body: bytes, unknown: bool = False) -> bytes:
    ident = eid.to_bytes((eid.bit_length() + 7) // 8, "big")
    return ident + (_UNKNOWN if unknown else _vint(len(body))) + body


def _uint(eid: int, v: int) -> bytes:
    return _el(eid, v.to_bytes(max(1, (v.bit_length() + 7) // 8), "big"))


def _block_body(track: int, timecode: int, flags: int, frames: Sequence[bytes]) -> bytes:
    """A (Simple)Block body: the track, its timecode, flags and the frames,
    Xiph-laced when there are several."""
    body = _vint(track) + struct.pack(">h", timecode)
    if len(frames) == 1:
        return body + bytes([flags]) + frames[0]
    lace = bytearray([len(frames) - 1])
    for f in frames[:-1]:
        n = len(f)
        while n >= 255:
            lace.append(255)
            n -= 255
        lace.append(n)
    return body + bytes([flags | 0x02]) + bytes(lace) + b"".join(frames)


def mux_webm(codec_id: str, codec_private: bytes, rate: float, channels: int,
             packets: Sequence[bytes], packet_ms: Sequence[float], *, unknown_sizes: bool = False,
             lace: int = 1, block_groups: bool = False) -> bytes:
    """A WebM file of one audio track: EBML header, Segment (Info, Tracks
    with the ``CodecPrivate``, Clusters of a second of SimpleBlocks or
    BlockGroups, ``lace`` packets a block); ``packet_ms`` is each packet's
    duration.
    ``unknown_sizes`` writes the Segment and the Clusters with unknown
    sizes, as a live muxer does."""
    header = _el(0x1A45DFA3, _uint(0x4286, 1) + _uint(0x42F7, 1) + _uint(0x42F2, 4)
                 + _uint(0x42F3, 8) + _el(0x4282, b"webm") + _uint(0x4287, 4) + _uint(0x4285, 2))
    info = _el(0x1549A966, _uint(0x2AD7B1, 1_000_000) + _el(0x4D80, b"soundkit")
               + _el(0x5741, b"soundkit"))
    audio = _el(0xE1, _el(0xB5, struct.pack(">d", float(rate))) + _uint(0x9F, channels))
    entry = _el(0xAE, _uint(0xD7, 1) + _uint(0x73C5, 1) + _uint(0x83, 2)
                + _el(0x86, codec_id.encode("ascii")) + _el(0x63A2, codec_private) + audio)
    tracks = _el(0x1654AE6B, entry)
    clusters, blocks, start, t = [], [], 0, 0.0
    starts = []
    for i in range(0, len(packets), lace):
        starts.append((t, packets[i:i + lace]))
        t += sum(packet_ms[i:i + lace])

    def close():
        if blocks:
            clusters.append(_el(0x1F43B675, _uint(0xE7, start) + b"".join(blocks),
                                unknown=unknown_sizes))

    for when, frames in starts:
        ms = int(when)
        if not blocks or ms - start >= 1000:
            close()
            blocks, start = [], ms
        body = _block_body(1, ms - start, 0x80 if not block_groups else 0x00, frames)
        blocks.append(_el(0xA0, _el(0xA1, body)) if block_groups else _el(0xA3, body))
    close()
    return header + _el(0x18538067, info + tracks + b"".join(clusters), unknown=unknown_sizes)


def _webm(name: str, packets=None) -> bytes:
    private, units_ = units(name)
    packets = units_ if packets is None else packets
    if name == "webm_vorbis":
        from soundkit_tpu_torch.codecs.vorbis import split_xiph_extradata

        ident = split_xiph_extradata(private)[0]
        rate = struct.unpack_from("<I", ident, 12)[0]
        # a packet's share of time: the clip's mean, for the timecodes only
        return mux_webm("A_VORBIS", private, rate, ident[11], packets,
                        [1024 * 1000 / rate] * len(packets), lace=2)
    from soundkit_tpu_torch.codecs.opus_core import packet_duration_48k

    ms = [packet_duration_48k(p) / 48 for p in packets]
    return mux_webm("A_OPUS", private, 48000, private[9], packets, ms,
                    unknown_sizes=name != "webm_opus_celt",
                    block_groups=name == "webm_opus_silk")


# ---------------------------------------------------------------------------
# MPEG-TS
# ---------------------------------------------------------------------------

def _crc32_mpeg(data: bytes) -> int:
    crc = 0xFFFFFFFF
    for b in data:
        crc ^= b << 24
        for _ in range(8):
            crc = ((crc << 1) ^ 0x04C11DB7) if crc & 0x80000000 else crc << 1
            crc &= 0xFFFFFFFF
    return crc


def _ts_packets(pid: int, payload: bytes, pusi: bool, cc: List[int]) -> bytes:
    """``payload`` over 188-byte packets of ``pid``, the last padded by its
    adaptation field; ``cc`` holds the pid's continuity counter."""
    out = bytearray()
    for off in range(0, len(payload), 184):
        body = payload[off:off + 184]
        start = pusi and off == 0
        pad = 184 - len(body)
        afc = 0x30 if pad else 0x10
        out += bytes([0x47, (0x40 if start else 0) | (pid >> 8), pid & 0xFF, afc | (cc[0] & 0xF)])
        if pad:
            out += bytes([pad - 1]) + (b"\x00" + b"\xff" * (pad - 2) if pad > 1 else b"")
        out += body
        cc[0] += 1
    return bytes(out)


def _psi(table: bytes) -> bytes:
    """A PSI section with its pointer field and MPEG CRC-32."""
    return b"\x00" + table + _crc32_mpeg(table).to_bytes(4, "big")


def _pts(pts: int) -> bytes:
    return bytes([0x21 | ((pts >> 29) & 0x0E), (pts >> 22) & 0xFF, ((pts >> 14) & 0xFE) | 1,
                  (pts >> 7) & 0xFF, ((pts << 1) & 0xFE) | 1])


def mux_ts(tracks: Sequence[Tuple[int, int, List[Tuple[bytes, int]]]]) -> bytes:
    """An MPEG-TS of one program: ``tracks`` [(stream_type, pid, [(PES
    payload, PTS at 90 kHz), ...])], listed in the PMT in that order, their
    PES interleaved one each in turn; PAT and PMT (pid 0x100) first and
    again after every 40 packets or so, a null packet after the first."""
    pmt_pid = 0x100
    pat = bytes([0x00, 0xB0, 0x0D, 0x00, 0x01, 0xC1, 0x00, 0x00,
                 0x00, 0x01, 0xE0 | (pmt_pid >> 8), pmt_pid & 0xFF])
    es = b"".join(bytes([st, 0xE0 | (pid >> 8), pid & 0xFF, 0xF0, 0x00]) for st, pid, _ in tracks)
    length = 13 + len(es)
    pmt = bytes([0x02, 0xB0 | (length >> 8), length & 0xFF, 0x00, 0x01, 0xC1, 0x00, 0x00,
                 0xE0 | (tracks[0][1] >> 8), tracks[0][1] & 0xFF, 0xF0, 0x00]) + es
    cc: Dict[int, List[int]] = {}

    def psi() -> bytes:
        return (_ts_packets(0, _psi(pat), True, cc.setdefault(0, [0]))
                + _ts_packets(pmt_pid, _psi(pmt), True, cc.setdefault(pmt_pid, [0])))

    out = bytearray(psi())
    out += bytes([0x47, 0x1F, 0xFF, 0x10]) + b"\xff" * 184  # a null packet
    since = 0
    for k in range(max(len(t[2]) for t in tracks)):
        for i, (_st, pid, pes) in enumerate(tracks):
            if k >= len(pes):
                continue
            data, pts = pes[k]
            length = len(data) + 8
            head = b"\x00\x00\x01" + bytes([0xC0 + i]) + struct.pack(
                ">H", length if length < 65536 else 0) + b"\x80\x80\x05" + _pts(pts)
            chunk = _ts_packets(pid, head + data, True, cc.setdefault(pid, [0]))
            out += chunk
            since += len(chunk) // 188
            if since >= 40:
                out += psi()
                since = 0
    return bytes(out)


def _pes_groups(frames: Sequence[bytes], per: int, ticks: int) -> List[Tuple[bytes, int]]:
    """Frames grouped ``per`` a PES, each PES's PTS at ``ticks`` (90 kHz) a frame."""
    return [(b"".join(frames[i:i + per]), 9000 + i * ticks) for i in range(0, len(frames), per)]


def ts_tracks() -> Dict[str, Tuple[int, int, list]]:
    """The three tracks of the MPEG-TS cases, {name: (stream_type, pid, PES)}."""
    adts = adts_frames(_AAC_CLIP["ts_adts"], TS_UNITS)
    asc, aus = aac_units(_AAC_CLIP["ts_latm"], TS_UNITS)
    info = _asc_info(asc)
    # one LOAS frame an access unit, every 8th carrying the StreamMuxConfig
    loas = [_loas_frame(au, info, i % 8 == 0) for i, au in enumerate(aus)]
    mp3 = mp3_frames()
    return {"ts_adts": (0x0F, 0x101, _pes_groups(adts, 4, 1920)),
            "ts_latm": (0x11, 0x102, _pes_groups(loas, 4, 1920)),
            "ts_mp3": (0x03, 0x103, _pes_groups(mp3, 3, 2351))}


def _loas_frame(au: bytes, info, with_config: bool) -> bytes:
    """One LOAS frame of ``au`` (``latm.mux_loas``'s framing)."""
    from soundkit_tpu_torch.demux.latm import write_audio_mux_element

    payload = write_audio_mux_element(au, info, include_config=with_config)
    return bytes([0x56, 0xE0 | (len(payload) >> 8), len(payload) & 0xFF]) + payload


def _ts(name: str) -> bytes:
    tracks = ts_tracks()
    order = [name] + [t for t in TS if t != name]
    return mux_ts([tracks[t] for t in order])


# ---------------------------------------------------------------------------
# cases
# ---------------------------------------------------------------------------

def _from_units(name: str, config: bytes, packets: List[bytes]) -> bytes:
    if name in M4A:
        from soundkit_tpu_torch.tools.host_codec_fixtures import mux_mp4

        info = _asc_info(config)
        return mux_mp4("aac", config, packets, info.sample_rate, info.channels, 1024)
    if name in LATM:
        from soundkit_tpu_torch.demux.latm import mux_loas

        return mux_loas(packets, _asc_info(config), config_period=int(name.split("_")[1]))
    return _webm(name, packets)


def build(name: str) -> bytes:
    """The bytes of case ``name``."""
    if name in TS:
        return _ts(name)
    return _from_units(name, *units(name))


def unit_seconds(name: str, packets: List[bytes]) -> float:
    """Seconds of audio ``packets`` of a decodable case give (before an
    Opus pre-skip)."""
    if name in M4A or name in LATM:
        return len(packets) * 1024 / 48000
    if name == "webm_vorbis":
        from soundkit_tpu_torch.tools import vorbis_fixtures as vf

        clip = vf.load_clips(names=("stereo44",))[0]
        return _vorbis_samples(clip, packets) / clip.rate
    from soundkit_tpu_torch.codecs.opus_core import packet_duration_48k

    return sum(packet_duration_48k(p) for p in packets) / 48000


def _vorbis_samples(clip, packets: List[bytes]) -> int:
    """Samples a channel of a Vorbis packet sequence decodes to: nothing
    for the first packet, then a quarter of each packet's and its
    predecessor's block (the block size read from the packet's mode)."""
    from soundkit_tpu_torch.codecs.vorbis_core import BitReader, cached_setup
    from soundkit_tpu_torch.demux.ogg import OggPacketizer

    headers = [p for p, _ in OggPacketizer().push(clip.header)]
    setup = cached_setup(headers[0], headers[2])
    sizes = []
    for packet in packets:
        br = BitReader(packet)
        br.read1()  # the packet type: 0, audio
        mode = setup.modes[br.read(setup._mode_bits)]
        sizes.append(setup.blocksize1 if mode.blockflag else setup.blocksize0)
    return sum(a // 4 + b // 4 for a, b in zip(sizes, sizes[1:]))


def long_stream(name: str, seconds: float) -> Tuple[bytes, float]:
    """(bytes, seconds of audio): decodable case ``name`` made at least
    ``seconds`` long, its units repeated in its own container."""
    config, packets = units(name)
    reps = max(1, math.ceil(seconds / unit_seconds(name, packets)))
    longer = packets * reps
    return _from_units(name, config, longer), unit_seconds(name, longer)


# ---------------------------------------------------------------------------
# AudioTrackDemuxer events
# ---------------------------------------------------------------------------

def event_records(events) -> list:
    """``AudioTrackDemuxer`` events as JSON-able records: the kind, then
    each field in order, enums by value, bytes as hex."""
    import dataclasses
    import enum

    out = []
    for ev in events:
        rec = [type(ev).__name__]
        for f in dataclasses.fields(ev):
            v = getattr(ev, f.name)
            rec.append(v.value if isinstance(v, enum.Enum) else
                       v.hex() if isinstance(v, (bytes, bytearray)) else v)
        out.append(rec)
    return out


def events_digest(events) -> dict:
    """The index's form of a case's events: the config records whole,
    the number of events and the SHA-256 of all records."""
    recs = event_records(events)
    return dict(configs=[r for r in recs if r[0] == "AudioTrackConfig"], events=len(recs),
                sha256=sha256(json.dumps(recs, separators=(",", ":")).encode()))


def demux_events(demuxer, data: bytes, chunk: int = 0) -> list:
    """Every event of ``demuxer`` fed ``data`` in ``chunk``-byte pushes
    (whole when 0), then flushed."""
    events = []
    step = chunk or max(1, len(data))
    for i in range(0, len(data), step):
        events += demuxer.push(data[i:i + step])
    return events + demuxer.flush()
