"""In-repo Ogg Opus fixtures for the port's tests and ``chip_smoke.py``.

Ten seeded synthetic 48 kHz clips, encoded to single-frame 20 ms packets
and muxed one packet a page, committed under
``tests/data/torch_port/opus/``. Four CELT clips (``CLIPS``):

- ``stereo96``: stereo, 96 kbit/s, libopus, 2.5 s: a pitched tone with
  attacks, so that most frames carry the comb postfilter and some are
  transient (eight short blocks); pre-skip 312;
- ``mono64``: the same signal in mono, 64 kbit/s, libopus, 2.5 s (in a
  stereo lane the parse duplicates the channel);
- ``owned``: stereo, 96 kbit/s, the JAX package's own CELT encoder, 2 s:
  no postfilter at all, pre-skip 0;
- ``gain``: stereo, 64 kbit/s, libopus, 2 s, with an OpusHead output gain
  of -1200 (Q7.8 dB).

and six voice clips (``VOICE_CLIPS``), 3 s of a synthetic voice (a gliding
harmonic source under moving resonances, pauses of noise, a 9 kHz
component) by libopus in its VoIP application, each forced to one mode and
one bandwidth, pre-skip 312:

- ``silk_nb``, ``silk_mb``, ``silk_wb``: SILK mono at 12, 16 and 20
  kbit/s (``silk_mb`` with an OpusHead output gain of -600);
- ``silk_wb_stereo``: SILK WB stereo at 24 kbit/s, its coding switched
  between mono and stereo every half second, with mid-only frames;
- ``hybrid_swb``: hybrid SWB mono at 24 kbit/s;
- ``hybrid_fb``: hybrid FB stereo at 32 kbit/s.

``index.json`` beside them holds each clip's channels, bit rate,
encoder, pre-skip, output gain, the length of its two header pages and
of every packet, and its counts of postfilter and transient frames (CELT)
or of stereo and mid-only frames (voice). This module reads the fixtures
and cuts lanes: lane ``i`` of a list of ``n`` clips takes clip ``i mod
n`` from packet ``7 (i // n)``, wrapping, and every fourth lane of a clip
plays a shorter stream (:func:`lane_packets`); its Ogg stream is the
clip's header pages and the pages of its packets, as a receiver joining
a broadcast sees them.

The streams an Ogg Opus fleet group hands to its host decoder
(:func:`reroute_case`, one per name of :data:`REROUTE_CASES`) are cut from
these clips, but for the hybrid one that starts on CELT-to-hybrid
transition redundancy: its four packets are committed as
``hybrid_redundancy.bin`` (each behind its u16 little-endian length; made
by libopus on the test side, ``torch_port_helpers.hybrid_redundancy_packets``).
The clips are made on the test side
(``tests/torch_port_helpers.py``; needs the JAX package and libopus),
from the repository's root::

    PYTHONPATH=. JAX_PLATFORMS=cpu python tests/torch_port_helpers.py opus
"""
from __future__ import annotations

import json
import struct
from pathlib import Path
from typing import List, NamedTuple

CLIPS = ("stereo96", "mono64", "owned", "gain")
VOICE_CLIPS = ("silk_nb", "silk_mb", "silk_wb", "silk_wb_stereo", "hybrid_swb", "hybrid_fb")
FIXTURE_DIR = Path(__file__).resolve().parents[2] / "tests" / "data" / "torch_port" / "opus"


class OpusClip(NamedTuple):
    name: str
    channels: int
    pre_skip: int
    output_gain: int
    header: bytes        # the OpusHead and OpusTags pages
    pages: List[bytes]   # one page a packet
    packets: List[bytes]

    @property
    def head(self) -> bytes:
        """The 19-byte OpusHead packet."""
        return (b"OpusHead" + bytes([1, self.channels]) + struct.pack("<H", self.pre_skip)
                + struct.pack("<I", 48000) + struct.pack("<h", self.output_gain) + b"\x00")

    def stream(self) -> bytes:
        return self.header + b"".join(self.pages)


def _pages(data: bytes) -> List[bytes]:
    """``data`` cut into its Ogg pages (their header and segment table
    read, no CRC check)."""
    pages, pos = [], 0
    while pos < len(data):
        if data[pos: pos + 4] != b"OggS":
            raise ValueError(f"no page at byte {pos}")
        nsegs = data[pos + 26]
        end = pos + 27 + nsegs + sum(data[pos + 27: pos + 27 + nsegs])
        pages.append(data[pos:end])
        pos = end
    return pages


def load_clips(directory: Path = FIXTURE_DIR, names=CLIPS) -> List[OpusClip]:
    """The committed clips ``names`` (the CELT clips by default), in that
    order, cut into their pages and packets."""
    index = json.loads((directory / "index.json").read_text())
    clips = []
    for name in names:
        data = (directory / f"{name}.opus").read_bytes()
        e = index[name]
        header, pages = data[: e["header"]], _pages(data[e["header"]:])
        if len(pages) != len(e["packets"]):
            raise ValueError(f"{name}: {len(pages)} pages for {len(e['packets'])} packets")
        packets = [p[len(p) - n:] for p, n in zip(pages, e["packets"])]
        clips.append(OpusClip(name, e["channels"], e["pre_skip"], e["output_gain"], header,
                              pages, packets))
    return clips


def _lane_cut(i: int, n_packets: int, n_clips: int = len(CLIPS)):
    """(first packet, packet count) of lane ``i`` of a clip of
    ``n_packets`` among ``n_clips``: lane i starts at packet
    ``7 * (i // n_clips) mod n_packets``, wrapping; every fourth lane of a
    clip plays 1/8 to 7/8 of it."""
    r = i // n_clips
    start = (7 * r) % n_packets
    count = n_packets if r % 4 != 3 else max(1, n_packets * (1 + (r // 4) % 7) // 8)
    return start, count


def lane_packets(clips: List[OpusClip], lane: int, n_packets: int = None):
    """(clip, indices of its packets in play order) of smoke lane
    ``lane``: clip ``lane mod len(clips)``, cut by :func:`_lane_cut`, at
    most ``n_packets`` packets if given."""
    clip = clips[lane % len(clips)]
    start, count = _lane_cut(lane, len(clip.packets), len(clips))
    if n_packets is not None:
        count = min(count, n_packets)
    return clip, [(start + t) % len(clip.packets) for t in range(count)]


def lane_streams(clips: List[OpusClip], num_lanes: int, n_packets: int = None) -> List[bytes]:
    """The Ogg Opus bytes of ``num_lanes`` ragged smoke lanes: the clip's
    header pages, then its packets' pages in play order."""
    out = []
    for i in range(num_lanes):
        clip, idx = lane_packets(clips, i, n_packets)
        out.append(clip.header + b"".join(clip.pages[t] for t in idx))
    return out


def lane_raw(clips: List[OpusClip], num_lanes: int, n_packets: int = None) -> List[bytes]:
    """The same lanes in soundkit's raw-Opus framing: the OpusHead, then
    each packet behind its u16 little-endian length."""
    out = []
    for i in range(num_lanes):
        clip, idx = lane_packets(clips, i, n_packets)
        out.append(clip.head + b"".join(struct.pack("<H", len(clip.packets[t])) + clip.packets[t]
                                        for t in idx))
    return out


def lane_frames(clips: List[OpusClip], lane: int, n_packets: int = None):
    """The packets of smoke lane ``lane`` (:func:`lane_packets`) split
    by their TOC, as ``push_packet`` of the SILK and hybrid decoders
    takes them: [(frame, TOC bandwidth, coded channels)]. Every packet
    must be a code-0 (single-frame) packet."""
    from soundkit_tpu_torch.codecs.opus_core import TOC_ATTRS

    clip, idx = lane_packets(clips, lane, n_packets)
    out = []
    for t in idx:
        pkt = clip.packets[t]
        _, _, stereo, bw, code = TOC_ATTRS[pkt[0]]
        if code != 0:
            raise ValueError(f"{clip.name} packet {t}: code {code}, not a single frame")
        out.append((pkt[1:], bw, 2 if stereo else 1))
    return out


REROUTE_CASES = ("silk_bandwidth_switch", "ten_ms_celt", "code3_multiframe", "mapping_family_1",
                 "three_channels", "mode_switch", "hybrid_redundancy_start")


def ogg_stream(head: bytes, packets) -> bytes:
    """An Ogg Opus stream of ``head`` (an OpusHead), an OpusTags page and
    one page a packet."""
    from soundkit_tpu_torch.demux.ogg import build_ogg_page

    tags = b"OpusTags" + struct.pack("<I", 2) + b"sk" + struct.pack("<I", 0)
    pages = [build_ogg_page([head], 7, 0, 0, header_type=2), build_ogg_page([tags], 7, 1, 0)]
    for i, p in enumerate(packets):
        pages.append(build_ogg_page([p], 7, 2 + i, 960 * (i + 1)))
    return b"".join(pages)


def hybrid_redundancy_packets(directory: Path = FIXTURE_DIR) -> List[bytes]:
    """Four 20 ms hybrid FB packets by libopus whose first carries
    CELT-to-hybrid transition redundancy."""
    data = (directory / "hybrid_redundancy.bin").read_bytes()
    out, pos = [], 0
    while pos < len(data):
        n = struct.unpack_from("<H", data, pos)[0]
        out.append(data[pos + 2: pos + 2 + n])
        pos += 2 + n
    return out


def reroute_case(case: str, directory: Path = FIXTURE_DIR):
    """(OpusHead, packets, the group's reason) of an Ogg Opus stream that
    the fleet's Opus group hands to its host decoder: a SILK NB stream
    that switches to WB, a 10 ms CELT packet, a code-3 packet of two
    frames, an OpusHead of mapping family 1 without its channel mapping
    table or of three channels in family 0 (heads neither package opens:
    the fleet refuses them), a switch from CELT to SILK in mid-stream, and
    a hybrid stream that starts on a transition-redundancy packet."""
    clip = load_clips(directory)[0]
    celt = clip.packets[:6]
    head2 = clip.head
    ten_ms = bytes([(30 << 3) | (celt[2][0] & 7)]) + celt[2][1:]  # CELT FB 10 ms
    frame = celt[3][1:]
    multi = bytes([celt[3][0] | 3, 2]) + frame + frame  # code 3, two CBR frames
    family1 = head2[:18] + b"\x01"
    three = head2[:9] + b"\x03" + head2[10:]
    voice = {c.name: c for c in load_clips(directory, names=VOICE_CLIPS)}
    nb, wb = voice["silk_nb"].packets, voice["silk_wb"].packets
    return {
        "silk_bandwidth_switch": (head2, nb[:4] + wb[4:6], "silk bandwidth switch"),
        "ten_ms_celt": (head2, celt[:2] + [ten_ms], "non-20ms/multiframe"),
        "code3_multiframe": (head2, celt[:3] + [multi], "non-20ms/multiframe"),
        "mapping_family_1": (family1, celt, "unsupported OpusHead"),
        "three_channels": (three, celt, "unsupported OpusHead"),
        "mode_switch": (head2, celt[:4] + nb[:1], "mid-stream mode switch"),
        "hybrid_redundancy_start": (head2, hybrid_redundancy_packets(directory),
                                    "hybrid transition redundancy"),
    }[case]
