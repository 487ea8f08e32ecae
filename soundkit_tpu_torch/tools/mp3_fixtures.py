"""In-repo MP3 fixtures for the port's tests and ``chip_smoke.py``.

Five seeded synthetic clips, encoded by libmp3lame (the JAX package's
``Mp3Encoder``) and committed under ``tests/data/torch_port/mp3/``:

- ``stereo44``: 44.1 kHz stereo, 128 kbit/s, 3 s of joint stereo: a
  correlated first half (M/S frames) with clicks and noise bursts that
  switch the blocks (types 1, 2, 3), then two independent channels;
- ``stereo48``: 48 kHz stereo, 128 kbit/s, 2 s;
- ``lsf22``: 22.05 kHz stereo, 64 kbit/s, 2 s (MPEG-2 LSF: one granule a
  frame);
- ``mono16``: 16 kHz mono, 32 kbit/s, 2 s (MPEG-2);
- ``mono8``: 8 kHz mono, 16 kbit/s, 2 s (MPEG-2.5).

``index.json`` beside them holds each clip's rate, channels and bit rate,
the length of every frame and its granule count, so that lanes can be cut
at frame boundaries. A lane that starts inside a clip begins with frames
whose bit reservoir points before its first byte; the parser drops those
until the reservoir fills, as a decoder joining a broadcast does. This
module reads the fixtures and cuts lanes. The clips are made on the test
side (``tests/torch_port_helpers.py``; needs the JAX package and
libavcodec), from the repository's root::

    PYTHONPATH=. JAX_PLATFORMS=cpu python tests/torch_port_helpers.py mp3
"""
from __future__ import annotations

import json
from pathlib import Path
from typing import List, NamedTuple

CLIPS = ("stereo44", "stereo48", "lsf22", "mono16", "mono8")
FIXTURE_DIR = Path(__file__).resolve().parents[2] / "tests" / "data" / "torch_port" / "mp3"


class Mp3Clip(NamedTuple):
    name: str
    rate: int
    channels: int
    bit_rate: int
    frames: List[bytes]
    granules: List[int]  # granules of each frame (2 for MPEG-1, 1 for LSF)

    def stream(self) -> bytes:
        return b"".join(self.frames)


def load_clips(directory: Path = FIXTURE_DIR) -> List[Mp3Clip]:
    """Every committed clip, in ``CLIPS`` order, cut into its frames."""
    index = json.loads((directory / "index.json").read_text())
    clips = []
    for name in CLIPS:
        data = (directory / f"{name}.mp3").read_bytes()
        e = index[name]
        offs = [0]
        for n in e["frames"]:
            offs.append(offs[-1] + n)
        if offs[-1] != len(data):
            raise ValueError(f"{name}: index covers {offs[-1]} bytes of {len(data)}")
        frames = [data[a:b] for a, b in zip(offs, offs[1:])]
        clips.append(Mp3Clip(name, e["rate"], e["channels"], e["bit_rate"], frames, e["granules"]))
    return clips


def _lane_cut(i: int, n_frames: int):
    """(first frame, frame count) of lane ``i`` of a clip of ``n_frames``:
    lane i starts at frame ``7 * (i // 5) mod n_frames``, wrapping; every
    fourth lane of a clip plays a shorter stream of 1/8 to 7/8 of it."""
    r = i // len(CLIPS)
    start = (7 * r) % n_frames
    count = n_frames if r % 4 != 3 else max(1, n_frames * (1 + (r // 4) % 7) // 8)
    return start, count


def lane_frames(clips: List[Mp3Clip], lane: int, n_frames: int = None):
    """(clip, indices of its frames in play order) of smoke lane
    ``lane``: clip ``lane mod 5``, cut by :func:`_lane_cut`, at most
    ``n_frames`` frames if given."""
    clip = clips[lane % len(clips)]
    start, count = _lane_cut(lane, len(clip.frames))
    if n_frames is not None:
        count = min(count, n_frames)
    return clip, [(start + t) % len(clip.frames) for t in range(count)]


def lane_streams(clips: List[Mp3Clip], num_lanes: int, n_frames: int = None) -> List[bytes]:
    """The MP3 bytes (whole frames) of ``num_lanes`` ragged smoke lanes."""
    out = []
    for i in range(num_lanes):
        clip, idx = lane_frames(clips, i, n_frames)
        out.append(b"".join(clip.frames[t] for t in idx))
    return out


def rotated_streams(clip: Mp3Clip, num_lanes: int) -> List[bytes]:
    """``num_lanes`` lanes that each play the whole of ``clip`` once, lane
    ``i`` from the first frame :func:`_lane_cut` gives it, wrapping: every
    lane as long as the clip (less the frames its reservoir drops)."""
    n = len(clip.frames)
    out = []
    for i in range(num_lanes):
        start = _lane_cut(i, n)[0]
        out.append(b"".join(clip.frames[(start + t) % n] for t in range(n)))
    return out


def lane_rates(clips: List[Mp3Clip], num_lanes: int) -> List[int]:
    """The sample rate of each smoke lane."""
    return [clips[i % len(clips)].rate for i in range(num_lanes)]
