"""Apple Core Audio Format (CAF) demux + mux for ALAC/LPCM tracks.

Parity object: the reference's ALAC decoder accepts "M4A/MP4 and CAF
containers" (soundkit-alac/src/lib.rs:6, via the Rust ``alac`` crate's
container reader).  This is an owned chunk walker, not a translation:
CAF is big-endian [type:4][size:i64] chunks after the ``caff`` file
header.

Chunks handled: ``desc`` (AudioStreamBasicDescription), ``kuki``
(codec magic cookie), ``pakt`` (VLQ base-128 packet sizes for VBR
codecs), ``data`` (u32 edit count + packet bytes).  For ALAC the kuki
is normalised to the 36-byte ``alac`` atom libavcodec expects
(12-byte size/tag/version header + 24-byte ALACSpecificConfig),
whether the file stores the bare 24-byte config or an atom-wrapped
cookie.
"""
from __future__ import annotations

import struct
from dataclasses import dataclass, field
from typing import List, Optional, Tuple


class CafError(ValueError):
    pass


@dataclass
class CafAudioTrack:
    codec: str                  # "alac" | "lpcm" | other fourcc (stripped)
    config: bytes               # normalised magic cookie (alac atom for ALAC)
    sample_rate: int
    channels: int
    bits_per_channel: int
    format_flags: int
    bytes_per_packet: int       # 0 = VBR
    frames_per_packet: int
    packets: List[bytes] = field(default_factory=list)


def _read_vlq(data: bytes, pos: int) -> Tuple[int, int]:
    """Base-128 big-endian variable-length quantity (pakt table entry)."""
    v = 0
    while True:
        if pos >= len(data):
            raise CafError("truncated pakt table")
        b = data[pos]
        pos += 1
        v = (v << 7) | (b & 0x7F)
        if not b & 0x80:
            return v, pos


def _write_vlq(v: int) -> bytes:
    out = bytearray([v & 0x7F])
    v >>= 7
    while v:
        out.append(0x80 | (v & 0x7F))
        v >>= 7
    return bytes(reversed(out))


def _normalise_alac_cookie(cookie: bytes) -> bytes:
    """Return the 36-byte ``alac`` atom (size + tag + version + config).

    Kuki layouts in the wild: bare 24-byte ALACSpecificConfig
    ("new kuki"), the 36-byte atom itself, or a 12-byte
    ``frma``+``alac`` preamble followed by the atom.
    """
    if len(cookie) == 24:  # bare ALACSpecificConfig ("new kuki")
        return struct.pack(">I", 36) + b"alac" + b"\x00" * 4 + cookie
    if cookie[4:8] == b"frma" and cookie[8:12] == b"alac":
        cookie = cookie[12:]
    if cookie[4:8] == b"alac" and len(cookie) >= 36:
        return cookie[:36]
    return cookie


def demux_caf_audio(data: bytes) -> CafAudioTrack:
    if len(data) < 8 or data[:4] != b"caff":
        raise CafError("not a CAF file")
    pos = 8  # 'caff' + version u16 + flags u16

    desc = None
    kuki = b""
    pakt_sizes: Optional[List[int]] = None
    payload = None

    while pos + 12 <= len(data):
        ctype = data[pos : pos + 4]
        (csize,) = struct.unpack(">q", data[pos + 4 : pos + 12])
        body_start = pos + 12
        if csize == -1:  # unknown size: data chunk extends to EOF
            body_end = len(data)
        else:
            body_end = min(body_start + csize, len(data))
        body = data[body_start:body_end]
        if ctype == b"desc":
            if len(body) < 32:
                raise CafError("short desc chunk")
            rate, fmt, flags, bpp, fpp, cpf, bits = struct.unpack(
                ">d4sIIIII", body[:32]
            )
            desc = (rate, fmt, flags, bpp, fpp, cpf, bits)
        elif ctype == b"kuki":
            kuki = body
        elif ctype == b"pakt":
            if len(body) < 24:
                raise CafError("short pakt chunk")
            (num_packets,) = struct.unpack(">q", body[:8])
            sizes = []
            p = 24  # skip num_valid_frames i64, priming i32, remainder i32
            for _ in range(num_packets):
                v, p = _read_vlq(body, p)
                sizes.append(v)
            pakt_sizes = sizes
        elif ctype == b"data":
            if len(body) < 4:
                raise CafError("short data chunk")
            payload = body[4:]  # skip u32 edit count
        pos = body_end

    if desc is None:
        raise CafError("no desc chunk")
    if payload is None:
        raise CafError("no data chunk")
    rate, fmt, flags, bpp, fpp, cpf, bits = desc
    codec = fmt.decode("latin1").strip()

    packets: List[bytes] = []
    if bpp:  # CBR: fixed-size packets
        for off in range(0, len(payload) - bpp + 1, bpp):
            packets.append(payload[off : off + bpp])
    elif pakt_sizes is not None:
        off = 0
        for s in pakt_sizes:
            if off + s > len(payload):
                break
            packets.append(payload[off : off + s])
            off += s
    else:
        raise CafError("VBR data without pakt chunk")

    config = _normalise_alac_cookie(kuki) if codec == "alac" else kuki
    return CafAudioTrack(
        codec=codec,
        config=config,
        sample_rate=int(rate),
        channels=cpf,
        bits_per_channel=bits,
        format_flags=flags,
        bytes_per_packet=bpp,
        frames_per_packet=fpp,
        packets=packets,
    )


def mux_caf_alac(
    packets: List[bytes],
    alac_atom: bytes,
    sample_rate: int,
    channels: int,
    bits: int,
    frames_per_packet: int = 4096,
    valid_frames: Optional[int] = None,
) -> bytes:
    """Write an ALAC CAF file (new-style 24-byte kuki)."""
    cookie = alac_atom[12:] if alac_atom[4:8] == b"alac" else alac_atom

    def chunk(ctype: bytes, body: bytes) -> bytes:
        return ctype + struct.pack(">q", len(body)) + body

    desc = struct.pack(
        ">d4sIIIII", float(sample_rate), b"alac", 0, 0, frames_per_packet,
        channels, bits,
    )
    table = b"".join(_write_vlq(len(p)) for p in packets)
    nvalid = valid_frames if valid_frames is not None else len(packets) * frames_per_packet
    pakt = struct.pack(">qqii", len(packets), nvalid, 0, 0) + table
    data = struct.pack(">I", 0) + b"".join(packets)
    return (
        b"caff" + struct.pack(">HH", 1, 0)
        + chunk(b"desc", desc)
        + chunk(b"kuki", cookie)
        + chunk(b"pakt", pakt)
        + chunk(b"data", data)
    )
