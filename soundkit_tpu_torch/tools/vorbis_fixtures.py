"""In-repo Ogg Vorbis fixtures for the port's tests and ``chip_smoke.py``.

Four seeded clips, committed under ``tests/data/torch_port/vorbis/``:

- ``stereo44``: 44.1 kHz stereo, 3 s, by libvorbis: a tone under clicks
  and noise bursts on the left, uncorrelated noise on the right, so that
  short blocks, every (previous, current) block-size case and
  square-polar coupling occur; blocksizes (256, 2048);
- ``stereo44b``: a second 44.1 kHz stereo clip of the same topology
  (other tones and bursts, 2.5 s), so that lanes differ;
- ``mono22``: 22.05 kHz mono, 2 s, by libvorbis: another topology, for
  the mismatch and refusal tests;
- ``floor0``: a crafted 8 kHz mono stream whose floors are floor type 0
  (LSP), blocksizes (256, 256): its packets take the Python packet path,
  since the C++ parse serves floor1 streams only.

The libvorbis clips hold whole packets a page (a page is closed before a
packet would make its body pass 4096 bytes), so every page boundary is a
packet boundary. ``index.json`` beside them holds each clip's rate,
channels, ``(blocksize0, blocksize1)``, the length of its header pages
and of every audio page. This module reads the fixtures and cuts lanes:
lane ``i`` of a list of ``n`` clips plays clip ``i mod n`` from its
headers, then its audio pages from page ``3 (i // n)``, wrapping, and
every fourth lane of a clip plays a shorter stream (:func:`lane_pages`);
:func:`lane_samples` counts the samples a lane decodes to.
The clips are made on the test side (``tests/torch_port_helpers.py``;
needs the JAX package and libvorbis), from the repository's root::

    PYTHONPATH=. JAX_PLATFORMS=cpu python tests/torch_port_helpers.py vorbis
"""
from __future__ import annotations

import json
from pathlib import Path
from typing import List, NamedTuple, Tuple

import numpy as np

CLIPS = ("stereo44", "stereo44b", "mono22", "floor0")
#: the clips of the smoke path: one topology, (256, 2048) stereo at 44.1 kHz
STEREO = ("stereo44", "stereo44b")
FIXTURE_DIR = Path(__file__).resolve().parents[2] / "tests" / "data" / "torch_port" / "vorbis"


class VorbisClip(NamedTuple):
    name: str
    rate: int
    channels: int
    blocksizes: Tuple[int, int]
    header: bytes        # the pages of the three header packets
    pages: List[bytes]   # the audio pages, whole packets each

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


def load_clips(directory: Path = FIXTURE_DIR, names=CLIPS) -> List[VorbisClip]:
    """The committed clips ``names``, in that order, cut into their
    header and audio pages."""
    index = json.loads((directory / "index.json").read_text())
    clips = []
    for name in names:
        data = (directory / f"{name}.ogg").read_bytes()
        e = index[name]
        header, pages = data[: e["header"]], _pages(data[e["header"]:])
        if [len(p) for p in pages] != e["pages"]:
            raise ValueError(f"{name}: pages differ from the index")
        clips.append(VorbisClip(name, e["rate"], e["channels"], tuple(e["blocksizes"]), header,
                                pages))
    return clips


def lane_pages(clips: List[VorbisClip], lane: int, n_pages: int = None):
    """(clip, indices of its audio pages in play order) of lane ``lane``:
    clip ``lane mod len(clips)``, from page ``3 (lane // len(clips))``
    wrapping; every fourth lane of a clip plays 1/8 to 7/8 of it; at most
    ``n_pages`` pages if given."""
    clip = clips[lane % len(clips)]
    n = len(clip.pages)
    r = lane // len(clips)
    start = (3 * r) % n
    count = n if r % 4 != 3 else max(1, n * (1 + (r // 4) % 7) // 8)
    if n_pages is not None:
        count = min(count, n_pages)
    return clip, [(start + t) % n for t in range(count)]


def lane_streams(clips: List[VorbisClip], num_lanes: int, n_pages: int = None) -> List[bytes]:
    """The Ogg Vorbis bytes of ``num_lanes`` ragged lanes: the clip's
    header pages, then its audio pages in play order."""
    out = []
    for i in range(num_lanes):
        clip, idx = lane_pages(clips, i, n_pages)
        out.append(clip.header + b"".join(clip.pages[t] for t in idx))
    return out


def block_sizes(clip: VorbisClip) -> List[List[int]]:
    """Per audio page of ``clip``, the block size of each of its packets,
    read from each packet's mode number (its first bits)."""
    from soundkit_tpu_torch.codecs.vorbis_core import BitReader, cached_setup
    from soundkit_tpu_torch.demux.ogg import OggPacketizer

    headers = [p for p, _ in OggPacketizer().push(clip.header)]
    setup = cached_setup(headers[0], headers[2])
    out = []
    for page in clip.pages:
        sizes = []
        for packet, _ in OggPacketizer().push(page):
            br = BitReader(packet)
            br.read1()  # the packet type: 0, audio
            mode = setup.modes[br.read(setup._mode_bits)]
            sizes.append(setup.blocksize1 if mode.blockflag else setup.blocksize0)
        out.append(sizes)
    return out


def lane_samples(clips: List[VorbisClip], num_lanes: int, n_pages: int = None) -> np.ndarray:
    """The samples a channel of each of ``num_lanes`` lanes decodes to:
    nothing for a lane's first packet, then ``prev/4 + n/4`` a packet."""
    sizes = [block_sizes(c) for c in clips]
    out = np.zeros(num_lanes, np.int64)
    for i in range(num_lanes):
        clip, idx = lane_pages(clips, i, n_pages)
        n = np.array([s for t in idx for s in sizes[i % len(clips)][t]])
        out[i] = int((n[:-1] // 4 + n[1:] // 4).sum())
    return out
