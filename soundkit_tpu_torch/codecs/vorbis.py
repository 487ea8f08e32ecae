"""Ogg Vorbis decoder (counterpart of ``soundkit_tpu/codecs/vorbis.py``,
copied but for its libavcodec branches): own Ogg packet parsing, the
three header packets (identification, comment, setup), then audio packet
decode through the port's copy of ``codecs/vorbis_core.py`` (codebooks,
floor 0 and floor 1, residue 0/1/2, coupling), all on the host.

The JAX package keeps a libavcodec decoder as the escape hatch for a
setup ``vorbis_core`` rejects with ``VorbisUnsupported`` (its
``VorbisDecoder._init_decoder`` and ``VorbisPacketDecoder.__init__``);
``vorbis_core`` raises that for no stream today, floor 0 included. The
port has no libavcodec: there it raises ``UnsupportedFormat``.
"""
from __future__ import annotations

import struct
from typing import List, Optional

import numpy as np

from soundkit_tpu_torch.codecs.vorbis_core import (
    VorbisSetup,
    cached_setup,
    VorbisStreamSynth,
    VorbisUnsupported,
)
from soundkit_tpu_torch.demux.ogg import OggPacketizer
from soundkit_tpu_torch.pipeline.output_options import UnsupportedFormat


def xiph_extradata(headers: List[bytes]) -> bytes:
    """Package header packets in Xiph lacing (avcodec vorbis extradata)."""
    out = bytearray([len(headers) - 1])
    for h in headers[:-1]:
        n = len(h)
        while n >= 255:
            out.append(255)
            n -= 255
        out.append(n)
    for h in headers:
        out.extend(h)
    return bytes(out)


def split_xiph_extradata(extradata: bytes) -> List[bytes]:
    """Inverse of :func:`xiph_extradata` (WebM CodecPrivate layout)."""
    nm1 = extradata[0]
    sizes = []
    p = 1
    for _ in range(nm1):
        s = 0
        while True:
            b = extradata[p]
            p += 1
            s += b
            if b != 255:
                break
        sizes.append(s)
    headers = []
    for s in sizes:
        headers.append(extradata[p : p + s])
        p += s
    headers.append(extradata[p:])
    return headers


def _no_libavcodec(e: Exception) -> UnsupportedFormat:
    return UnsupportedFormat(
        f"Unsupported format: Vorbis setup the owned decoder rejects ({e}); the JAX "
        "package decodes it through libavcodec, which the port does not have")


class VorbisPacketDecoder:
    """Raw-packet decode given the three header packets (the
    reference's lewton ``VorbisPacketDecoder``, lib.rs:198; used for
    WebM A_VORBIS tracks)."""

    def __init__(self, headers: List[bytes]):
        self.channels = headers[0][11]
        self.sample_rate = struct.unpack_from("<I", headers[0], 12)[0]
        self._av = None
        try:
            self._setup = cached_setup(bytes(headers[0]), bytes(headers[2]))
            self._synth = VorbisStreamSynth(self._setup)
        except VorbisUnsupported as e:
            raise _no_libavcodec(e)

    def decode_packet_f32(self, packet: bytes) -> np.ndarray:
        """One audio packet -> interleaved f32 (may be empty)."""
        if self._av is not None:
            return self._av.push(packet)
        spec = self._setup.decode_packet_spectrum(packet)
        if spec is None:
            return np.zeros(0, dtype=np.float32)
        pcm = self._synth.synthesize(spec)
        return pcm.T.reshape(-1).astype(np.float32)

    def flush(self) -> np.ndarray:
        if self._av is not None:
            return self._av.flush()
        return np.zeros(0, dtype=np.float32)


class VorbisDecoder:
    def __init__(self) -> None:
        self._pkts = OggPacketizer()
        self._headers: List[bytes] = []
        self._setup: Optional[VorbisSetup] = None
        self._synth: Optional[VorbisStreamSynth] = None
        self._av = None  # floor0 fallback only
        self.sample_rate: Optional[int] = None
        self.channels: Optional[int] = None

    def _init_decoder(self) -> None:
        try:
            self._setup = cached_setup(bytes(self._headers[0]), bytes(self._headers[2]))
            self._synth = VorbisStreamSynth(self._setup)
        except VorbisUnsupported as e:
            raise _no_libavcodec(e)

    def decode_f32(self, data: bytes) -> np.ndarray:
        out = []
        for packet, _g in self._pkts.push(data):
            if self._setup is None and self._av is None:
                if len(self._headers) == 0:
                    if len(packet) < 30 or packet[:7] != b"\x01vorbis":
                        raise ValueError("not a Vorbis identification header")
                    self.channels = packet[11]
                    self.sample_rate = struct.unpack_from("<I", packet, 12)[0]
                self._headers.append(packet)
                if len(self._headers) == 3:
                    self._init_decoder()
                continue
            if self._av is not None:
                out.append(self._av.push(packet))
                continue
            spec = self._setup.decode_packet_spectrum(packet)
            if spec is None:
                continue
            pcm = self._synth.synthesize(spec)  # [ch, n]
            out.append(pcm.T.reshape(-1).astype(np.float32))
        return np.concatenate(out) if out else np.zeros(0, dtype=np.float32)

    def decode_i16(self, data: bytes) -> np.ndarray:
        from soundkit_tpu_torch.codecs.avdec import f32_to_i16

        return f32_to_i16(self.decode_f32(data))

    def flush(self) -> np.ndarray:
        if self._av is not None:
            return self._av.flush()
        return np.zeros(0, dtype=np.float32)
