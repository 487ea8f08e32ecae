"""In-repo FLAC fixtures for the port's tests and ``chip_smoke.py``.

Four seeded synthetic clips, encoded with the JAX package's owned FLAC
encoder at a block size of 4096 and committed under
``tests/data/torch_port/flac/<clip>.flac``:

- ``stereo16``: 16-bit stereo 44.1 kHz, 2 s (right/side frames, then mid/side;
  order-8 LPC);
- ``stereo24``: 24-bit stereo 48 kHz, 1 s (samples past the 16-bit range);
- ``mono16``: 16-bit mono 16 kHz, 2 s;
- ``const_wasted``: 16-bit stereo 44.1 kHz, 1 s, the left channel
  constant within each frame (CONSTANT subframes) and the right with
  two wasted bits.

``index.json`` beside them holds, per clip, the length of the stream
header (``fLaC`` and STREAMINFO) and of every frame, so that lanes can
be cut at frame boundaries: FLAC frames decode on their own. This module
reads the fixtures and cuts lanes. The clips are made on the test side
(``tests/torch_port_helpers.py``; needs the JAX package), from the
repository's root::

    PYTHONPATH=. JAX_PLATFORMS=cpu python tests/torch_port_helpers.py flac
"""
from __future__ import annotations

import json
from pathlib import Path
from typing import List, NamedTuple

CLIPS = ("stereo16", "stereo24", "mono16", "const_wasted")
FIXTURE_DIR = Path(__file__).resolve().parents[2] / "tests" / "data" / "torch_port" / "flac"
BLOCK_SIZE = 4096


class FlacClip(NamedTuple):
    name: str
    rate: int
    channels: int
    bits: int
    header: bytes
    frames: List[bytes]
    blocks: List[int]  # samples per channel of each frame

    def stream(self) -> bytes:
        return self.header + b"".join(self.frames)


def load_clips(directory: Path = FIXTURE_DIR) -> List[FlacClip]:
    """Every committed clip, in ``CLIPS`` order, cut into its frames."""
    index = json.loads((directory / "index.json").read_text())
    clips = []
    for name in CLIPS:
        data = (directory / f"{name}.flac").read_bytes()
        e = index[name]
        offs = [e["header"]]
        for n in e["frames"]:
            offs.append(offs[-1] + n)
        if offs[-1] != len(data):
            raise ValueError(f"{name}: index covers {offs[-1]} bytes of {len(data)}")
        frames = [data[a:b] for a, b in zip(offs, offs[1:])]
        clips.append(FlacClip(name, e["rate"], e["channels"], e["bits"], data[: e["header"]],
                              frames, e["blocks"]))
    return clips


def _lane_cut(i: int, n_frames: int):
    """(first frame, frame count) of lane ``i`` of a clip of ``n_frames``:
    lane i starts at frame ``7 * (i // 4) mod n_frames``, wrapping; every
    fourth lane of a clip plays a shorter stream of 1/8 to 7/8 of it."""
    r = i // len(CLIPS)
    start = (7 * r) % n_frames
    count = n_frames if r % 4 != 3 else max(1, n_frames * (1 + (r // 4) % 7) // 8)
    return start, count


def lane_frames(clips: List[FlacClip], lane: int, n_frames: int = None):
    """(clip, indices of its frames in play order) of smoke lane
    ``lane``: clip ``lane mod 4``, cut by :func:`_lane_cut`, at most
    ``n_frames`` frames if given."""
    clip = clips[lane % len(clips)]
    start, count = _lane_cut(lane, len(clip.frames))
    if n_frames is not None:
        count = min(count, n_frames)
    return clip, [(start + t) % len(clip.frames) for t in range(count)]


def lane_streams(clips: List[FlacClip], num_lanes: int, n_frames: int = None) -> List[bytes]:
    """The FLAC bytes (stream header and whole frames) of ``num_lanes``
    ragged smoke lanes."""
    out = []
    for i in range(num_lanes):
        clip, idx = lane_frames(clips, i, n_frames)
        out.append(clip.header + b"".join(clip.frames[t] for t in idx))
    return out


def lane_seconds(clips: List[FlacClip], num_lanes: int, n_frames: int = None) -> List[float]:
    """Seconds of audio each lane of :func:`lane_streams` carries, at
    its own rate."""
    out = []
    for i in range(num_lanes):
        clip, idx = lane_frames(clips, i, n_frames)
        out.append(sum(clip.blocks[t] for t in idx) / clip.rate)
    return out
