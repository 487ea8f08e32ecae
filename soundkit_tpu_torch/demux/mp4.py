"""MP4/M4A audio demuxer.

Behavioral equivalent of the reference's ``AacMp4Demuxer``
(soundkit-aac/src/lib.rs:261-360): buffer the container, walk the moov
sample tables, emit the audio track's access units plus its codec
config (AudioSpecificConfig from esds for AAC, or the alac magic
cookie).  The reference re-wraps AAC samples as ADTS; this demuxer
returns raw AUs + config (the decoder takes extradata directly).
"""
from __future__ import annotations

import struct
from dataclasses import dataclass, field
from typing import Iterator, List, Optional, Tuple


class Mp4Error(ValueError):
    pass


def _iter_boxes(data: bytes, start: int, end: int) -> Iterator[Tuple[bytes, int, int]]:
    pos = start
    while pos + 8 <= end:
        size = struct.unpack_from(">I", data, pos)[0]
        btype = data[pos + 4 : pos + 8]
        hdr = 8
        if size == 1:
            if pos + 16 > end:
                return
            size = struct.unpack_from(">Q", data, pos + 8)[0]
            hdr = 16
        elif size == 0:
            size = end - pos
        if size < hdr or pos + size > end:
            return
        yield btype, pos + hdr, pos + size
        pos += size


def _find(data: bytes, start: int, end: int, *path: bytes) -> Optional[Tuple[int, int]]:
    if not path:
        return (start, end)
    for btype, b, e in _iter_boxes(data, start, end):
        if btype == path[0]:
            return _find(data, b, e, *path[1:])
    return None


def _parse_esds_asc(esds: bytes) -> Optional[bytes]:
    """Extract the AudioSpecificConfig from an esds box body."""
    pos = 4  # version+flags
    def read_len(p):
        n = 0
        for _ in range(4):
            b = esds[p]
            p += 1
            n = (n << 7) | (b & 0x7F)
            if not (b & 0x80):
                break
        return n, p

    while pos < len(esds):
        tag = esds[pos]
        ln, pos = read_len(pos + 1)
        if tag == 0x03:  # ES_Descriptor: es_id(2) + flags(1), then children
            pos += 3
        elif tag == 0x04:  # DecoderConfigDescriptor: 13 bytes then children
            pos += 13
        elif tag == 0x05:  # DecoderSpecificInfo == ASC
            return esds[pos : pos + ln]
        else:
            pos += ln
    return None


@dataclass
class Mp4AudioTrack:
    codec: str  # "aac" | "alac" | other fourcc
    config: bytes  # ASC or alac cookie
    sample_rate: int
    channels: int
    samples: List[bytes] = field(default_factory=list)


def demux_mp4_audio(data: bytes) -> Mp4AudioTrack:
    moov = _find(data, 0, len(data), b"moov")
    if moov is None:
        raise Mp4Error("no moov box")
    mdat_spans = [(b, e) for t, b, e in _iter_boxes(data, 0, len(data)) if t == b"mdat"]
    if not mdat_spans:
        raise Mp4Error("no mdat box")

    for btype, tb, te in _iter_boxes(data, *moov):
        if btype != b"trak":
            continue
        stbl = _find(data, tb, te, b"mdia", b"minf", b"stbl")
        if stbl is None:
            continue
        stsd = _find(data, *stbl, b"stsd")
        if stsd is None:
            continue
        sb, se = stsd
        entry_count = struct.unpack_from(">I", data, sb + 4)[0]
        if entry_count < 1:
            continue
        # first sample entry
        ep = sb + 8
        esize = struct.unpack_from(">I", data, ep)[0]
        fourcc = data[ep + 4 : ep + 8]
        if fourcc not in (b"mp4a", b"alac", b"enca"):
            continue
        # AudioSampleEntry: 8 hdr + 8 reserved + 2 ch + 2 bits + 4 + 4 rate
        channels = struct.unpack_from(">H", data, ep + 24)[0]
        rate = struct.unpack_from(">I", data, ep + 32)[0] >> 16
        config = b""
        codec = fourcc.decode("ascii", "replace")
        for ct, cb, ce in _iter_boxes(data, ep + 36, ep + esize):
            if ct == b"esds":
                asc = _parse_esds_asc(data[cb:ce])
                if asc:
                    config = asc
                    codec = "aac"
            elif ct == b"alac":
                # full atom incl. size+tag header: the avcodec alac
                # decoder skips 12 bytes (size, tag, version) itself
                config = data[cb - 8 : ce]
                codec = "alac"
            elif ct == b"wave":  # QT-style nesting
                inner = _find(data, cb, ce, b"esds")
                if inner:
                    asc = _parse_esds_asc(data[inner[0] : inner[1]])
                    if asc:
                        config = asc
                        codec = "aac"

        # sample tables
        def table(name):
            span = _find(data, *stbl, name)
            return span

        stsz = table(b"stsz")
        stco = table(b"stco") or table(b"co64")
        stsc = table(b"stsc")
        if stsz is None or stco is None or stsc is None:
            raise Mp4Error("missing sample tables")

        zb, _ = stsz
        fixed = struct.unpack_from(">I", data, zb + 4)[0]
        count = struct.unpack_from(">I", data, zb + 8)[0]
        if fixed:
            sizes = [fixed] * count
        else:
            sizes = list(
                struct.unpack_from(f">{count}I", data, zb + 12)
            )

        cb_, ce_ = stco
        is64 = _find(data, *stbl, b"co64") is not None
        nchunks = struct.unpack_from(">I", data, cb_ + 4)[0]
        if is64:
            offsets = list(struct.unpack_from(f">{nchunks}Q", data, cb_ + 8))
        else:
            offsets = list(struct.unpack_from(f">{nchunks}I", data, cb_ + 8))

        scb, _ = stsc
        nstsc = struct.unpack_from(">I", data, scb + 4)[0]
        stsc_rows = [
            struct.unpack_from(">III", data, scb + 8 + 12 * i) for i in range(nstsc)
        ]  # (first_chunk, samples_per_chunk, desc_id)

        # expand samples-per-chunk over chunks
        samples: List[bytes] = []
        si = 0
        for ci in range(nchunks):
            spc = 0
            for first, per, _d in stsc_rows:
                if ci + 1 >= first:
                    spc = per
            off = offsets[ci]
            for _ in range(spc):
                if si >= count:
                    break
                sz = sizes[si]
                samples.append(data[off : off + sz])
                off += sz
                si += 1

        return Mp4AudioTrack(
            codec=codec, config=config, sample_rate=rate, channels=channels, samples=samples
        )
    raise Mp4Error("no audio track found")
