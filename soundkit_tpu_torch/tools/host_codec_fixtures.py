"""In-repo fixtures of the host codecs for the port's tests and
``chip_smoke.py``: GSM 06.10 (standard and WAV49), AC-3, Ogg Speex,
ALAC (in CAF and in MP4) and AIFF / AIFF-C.

Short seeded clips, committed under
``tests/data/torch_port/host_codecs/``:

- ``gsm_standard`` / ``gsm_wav49``: 2 s of 8 kHz speech-like sound by
  libgsm / libgsm_ms, 33-byte frames / 65-byte blocks;
- ``ac3_mono`` (96 kbit/s) / ``ac3_stereo`` (192 kbit/s), 0.5 s at 48
  kHz, ``ac3_51`` (448 kbit/s, six channels) 0.25 s, by libavcodec's
  ``ac3``; ``ac3_blksw``: ``ac3_stereo``'s syncframes with their block
  switch flags set (every block of the even frames, blocks 1 and 4 of
  the odd ones), so that short blocks occur;
- ``speex_nb`` / ``speex_wb`` (1 s) and ``speex_uwb`` (0.5 s), mono at 8,
  16 and 32 kHz, and ``speex_nb_stereo`` (1 s, in-band intensity
  stereo), by libspeex, one packet a page;
- ``alac_caf`` / ``alac_mp4``: the same 3 ALAC packets (4096 frames each)
  of 16-bit 44.1 kHz stereo PCM, by libavcodec's ``alac`` (which codes
  them at 24 bits, its first sample format being S32P; the decode shifts
  them back), in CAF and in MP4, lossless: ``source_sha256`` in the index
  is the source PCM's;
- ``aiff_8`` / ``aiff_16`` / ``aiff_24`` / ``aiff_32`` and ``aifc_sowt``,
  ``aifc_fl32``, ``aifc_fl64``, ``aifc_ulaw``, ``aifc_alaw``: 0.25 s of 8
  kHz stereo.

``index.json`` beside them holds each clip's file, its route into
``DecodePipeline`` (``spawn``: detection, or the explicit spawn), its
rate, channels and bits, the length and SHA-256 of the PCM bytes that
the JAX package's ``StreamDecoder`` gives for it, and what it takes to
lengthen it. ``reference_pcm.npz`` keeps that PCM (int16) for the AC-3
and Speex clips that ``chip_smoke.py`` lengthens (:data:`REFERENCE_PCM`),
whose float decoders may round otherwise on another machine, and for the
synthesized G.729 and AMR-NB clips beside them (``tools/celp_fixtures.py``).
This module reads them, writes AIFF and MP4 files
(:func:`build_aiff`, :func:`mux_mp4`), and makes long streams of a clip
by repeating its frames or packets (:func:`long_stream`): AC-3
syncframes, GSM frames, Speex and ALAC packets each decode as well
repeated, and an AIFF's sound data is tiled. A long stream's decode
begins with the clip's.

The clips are made on the test side (``tests/torch_port_helpers.py``;
needs the JAX package and FFmpeg's encoders), from the repository's
root::

    PYTHONPATH=. JAX_PLATFORMS=cpu python tests/torch_port_helpers.py host_codecs
"""
from __future__ import annotations

import hashlib
import json
import math
import struct
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np

FIXTURE_DIR = Path(__file__).resolve().parents[2] / "tests" / "data" / "torch_port" / "host_codecs"
GSM = ("gsm_standard", "gsm_wav49")
AC3 = ("ac3_mono", "ac3_stereo", "ac3_51", "ac3_blksw")
SPEEX = ("speex_nb", "speex_wb", "speex_uwb", "speex_nb_stereo")
ALAC = ("alac_caf", "alac_mp4")
AIFF = ("aiff_8", "aiff_16", "aiff_24", "aiff_32", "aifc_sowt", "aifc_fl32", "aifc_fl64",
        "aifc_ulaw", "aifc_alaw")
#: the float-decoded clips that ``chip_smoke.py`` lengthens, whose PCM is
#: committed: another machine's float64 sums may round them 1 LSB apart
REFERENCE_PCM = ("ac3_stereo", "speex_nb", "speex_wb", "speex_uwb")


def load_index(directory: Path = FIXTURE_DIR) -> Dict[str, dict]:
    return json.loads((directory / "index.json").read_text())


def clip_bytes(name: str, directory: Path = FIXTURE_DIR) -> bytes:
    return (directory / load_index(directory)[name]["file"]).read_bytes()


def reference_pcm(name: str, directory: Path = FIXTURE_DIR) -> np.ndarray:
    """The JAX package's int16 PCM of an AC-3, Speex, G.729 or AMR-NB clip,
    interleaved."""
    with np.load(directory / "reference_pcm.npz") as z:
        return z[name]


def sha256(data: bytes) -> str:
    return hashlib.sha256(data).hexdigest()


# ---------------------------------------------------------------------------
# writers
# ---------------------------------------------------------------------------

def _extended80(rate: float) -> bytes:
    """``rate`` as the 80-bit IEEE 754 extended float of an AIFF COMM chunk."""
    if rate <= 0:
        return bytes(10)
    mant, exp = math.frexp(rate)  # rate = mant * 2**exp, 0.5 <= mant < 1
    return struct.pack(">HQ", exp - 1 + 16383, int(mant * (1 << 64)))


def build_aiff(channels: int, bits: int, rate: int, sound: bytes,
               compression: Optional[bytes] = None) -> bytes:
    """An AIFF file (``compression`` None) or an AIFF-C file with that
    compression type, its sample frames the bytes ``sound`` as given."""
    width = {b"ulaw": 1, b"alaw": 1, b"fl32": 4, b"fl64": 8}.get(compression, (bits + 7) // 8)
    frames = len(sound) // (width * channels)
    comm = struct.pack(">hIh", channels, frames, bits) + _extended80(rate)
    if compression is not None:
        comm += compression + b"\x00\x00"  # an empty pascal string names it
    chunks = [b"COMM" + struct.pack(">I", len(comm)) + comm,
              b"SSND" + struct.pack(">III", 8 + len(sound), 0, 0) + sound + b"\x00" * (len(sound) & 1)]
    if compression is not None:
        chunks.insert(0, b"FVER" + struct.pack(">II", 4, 0xA2805140))
    body = (b"AIFC" if compression is not None else b"AIFF") + b"".join(chunks)
    return b"FORM" + struct.pack(">I", len(body)) + body


def _box(kind: bytes, *parts: bytes) -> bytes:
    body = b"".join(parts)
    return struct.pack(">I", 8 + len(body)) + kind + body


def _full_box(kind: bytes, *parts: bytes) -> bytes:
    return _box(kind, b"\x00\x00\x00\x00", *parts)


def _esds(asc: bytes) -> bytes:
    """An esds body: ES_Descriptor > DecoderConfigDescriptor (AAC) >
    DecoderSpecificInfo (the AudioSpecificConfig), SLConfig."""
    def desc(tag: int, body: bytes) -> bytes:
        return bytes([tag, len(body)]) + body

    dsi = desc(0x05, asc)
    dcd = desc(0x04, bytes([0x40, 0x15]) + bytes(3) + struct.pack(">II", 0, 0) + dsi)
    return desc(0x03, struct.pack(">HB", 1, 0) + dcd + desc(0x06, b"\x02"))


def mux_mp4(codec: str, config: bytes, samples: List[bytes], rate: int, channels: int,
            frames_per_sample: int, bits: int = 16) -> bytes:
    """An MP4 file of one audio track (``ftyp``, then ``moov`` with one
    ``trak``, then one ``mdat`` chunk): ``codec`` "alac" with ``config``
    the 36-byte ``alac`` atom of its sample entry, or "aac" with
    ``config`` the AudioSpecificConfig of its ``esds``."""
    if codec == "alac":
        child, fourcc = config, b"alac"
    elif codec == "aac":
        child, fourcc = _full_box(b"esds", _esds(config)), b"mp4a"
    else:
        raise ValueError(f"no MP4 sample entry for {codec!r}")
    entry = _box(fourcc, bytes(6), struct.pack(">H", 1), bytes(8),
                 struct.pack(">HHHH", channels, bits, 0, 0), struct.pack(">I", rate << 16), child)
    n = len(samples)
    duration = n * frames_per_sample

    def moov(mdat_offset: int) -> bytes:
        stbl = _box(b"stbl",
                    _full_box(b"stsd", struct.pack(">I", 1), entry),
                    _full_box(b"stts", struct.pack(">III", 1, n, frames_per_sample)),
                    _full_box(b"stsc", struct.pack(">IIII", 1, 1, n, 1)),
                    _full_box(b"stsz", struct.pack(">II", 0, n),
                              struct.pack(f">{n}I", *(len(s) for s in samples))),
                    _full_box(b"stco", struct.pack(">II", 1, mdat_offset)))
        minf = _box(b"minf", _full_box(b"smhd", bytes(4)), stbl)
        mdia = _box(b"mdia",
                    _full_box(b"mdhd", struct.pack(">IIIIHH", 0, 0, rate, duration, 0x55C4, 0)),
                    _full_box(b"hdlr", bytes(4), b"soun", bytes(12), b"sound\x00"),
                    minf)
        tkhd = _box(b"tkhd", struct.pack(">I", 7), bytes(80))
        mvhd = _full_box(b"mvhd", struct.pack(">IIII", 0, 0, rate, duration), bytes(80))
        return _box(b"moov", mvhd, _box(b"trak", tkhd, mdia))

    ftyp = _box(b"ftyp", b"M4A ", struct.pack(">I", 0), b"M4A mp42isom")
    head = len(ftyp) + len(moov(0)) + 8  # the mdat box's header ends here
    return ftyp + moov(head) + _box(b"mdat", *samples)


# ---------------------------------------------------------------------------
# long streams
# ---------------------------------------------------------------------------

def _aiff_parts(data: bytes):
    """(channels, bits, rate, compression or None, sound bytes) of an AIFF
    file this module wrote."""
    aifc = data[8:12] == b"AIFC"
    pos, comm, sound = 12, None, b""
    while pos + 8 <= len(data):
        cid, size = data[pos:pos + 4], struct.unpack(">I", data[pos + 4:pos + 8])[0]
        body = data[pos + 8:pos + 8 + size]
        if cid == b"COMM":
            comm = body
        elif cid == b"SSND":
            sound = body[8:]
        pos += 8 + size + (size & 1)
    channels, _frames, bits = struct.unpack(">hIh", comm[:8])
    exp, mant = struct.unpack(">HQ", comm[8:18])
    rate = round(mant * 2.0 ** (exp - 16383 - 63))
    return channels, bits, rate, comm[18:22] if aifc else None, sound


def _ogg_speex(header: bytes, comment: bytes, packets: List[bytes], serial: int = 0x5EE) -> bytes:
    from soundkit_tpu_torch.demux.ogg import build_ogg_page

    pages = [build_ogg_page([header], serial, 0, 0, header_type=2),
             build_ogg_page([comment], serial, 1, 0)]
    pages += [build_ogg_page([p], serial, 2 + i, 0) for i, p in enumerate(packets)]
    return b"".join(pages)


def long_stream(name: str, seconds: float, directory: Path = FIXTURE_DIR):
    """(bytes, seconds of audio): clip ``name`` made at least ``seconds``
    long, its frames, packets or sound data repeated in its own container
    (a G.729 or AMR-NB clip by ``celp_fixtures.long_stream``)."""
    from soundkit_tpu_torch.tools import celp_fixtures

    if name in celp_fixtures.CLIPS:
        return celp_fixtures.long_stream(name, seconds)
    e = load_index(directory)[name]
    data = clip_bytes(name, directory)
    reps = max(1, math.ceil(seconds / e["seconds"]))
    if name in GSM or name in AC3:
        out = data * reps
    elif name in SPEEX:
        from soundkit_tpu_torch.demux.ogg import OggPacketizer

        packets = [p for p, _g in OggPacketizer().push(data)]
        out = _ogg_speex(packets[0], packets[1], packets[2:] * reps)
    elif name == "alac_caf":
        from soundkit_tpu_torch.demux.caf import demux_caf_audio, mux_caf_alac

        t = demux_caf_audio(data)
        out = mux_caf_alac(t.packets * reps, t.config, t.sample_rate, t.channels,
                           t.bits_per_channel, t.frames_per_packet)
    elif name == "alac_mp4":
        from soundkit_tpu_torch.demux.mp4 import demux_mp4_audio

        t = demux_mp4_audio(data)
        out = mux_mp4("alac", t.config, t.samples * reps, t.sample_rate, t.channels,
                      e["frames_per_packet"], e["alac_bits"])
    else:
        channels, bits, rate, comp, sound = _aiff_parts(data)
        out = build_aiff(channels, bits, rate, sound * reps, comp)
    return out, reps * e["seconds"]
