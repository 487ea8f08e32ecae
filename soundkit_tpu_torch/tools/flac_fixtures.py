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
reads the fixtures and cuts lanes, and decodes whole streams with the
port's decoder (the PCM the batched encoder's checks feed it). The clips are made on the test side
(``tests/torch_port_helpers.py``; needs the JAX package), from the
repository's root::

    PYTHONPATH=. JAX_PLATFORMS=cpu python tests/torch_port_helpers.py flac
"""
from __future__ import annotations

import json
from pathlib import Path
from typing import List, NamedTuple

import numpy as np

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


def decode_streams(streams: List[bytes], device, stride: int = 4608) -> List[np.ndarray]:
    """Decode whole FLAC streams with the port's ``BatchedFlacDecoder`` on
    ``device``, one lane each: the samples of each, [channels, n] int64."""
    from soundkit_tpu_torch.models.flac_batch import BatchedFlacDecoder

    model = BatchedFlacDecoder(len(streams), stride, device=device)
    for i, s in enumerate(streams):
        model.push(i, s)
    rounds = max(model.lane_ready(i) for i in range(len(streams)))
    samples, metas = model.decode_batches(rounds)
    out = []
    for b in range(len(streams)):
        parts = [samples[f, b, : metas[f][b, 1], : metas[f][b, 0]]
                 for f in range(rounds) if metas[f][b, 0] > 0]
        out.append(np.concatenate(parts, axis=1).astype(np.int64))
    return out


def clip_pcm(clip: FlacClip, device) -> np.ndarray:
    """The PCM of a committed clip, [channels, n] int64, decoded by the
    port's own FLAC decoder on ``device``."""
    return decode_streams([clip.stream()], device)[0]


def rotated_lanes(pcms: List[np.ndarray], num_lanes: int, n: int) -> List[np.ndarray]:
    """``num_lanes`` lanes of ``n`` samples from clips' PCM [C, m]: lane i
    plays clip ``i mod len(pcms)`` from its own offset ``(7919 i) mod m``,
    wrapping around the clip as often as ``n`` needs."""
    idx = np.arange(n)
    out = []
    for i in range(num_lanes):
        pcm = pcms[i % len(pcms)]
        out.append(pcm[:, (7919 * i + idx) % pcm.shape[1]])
    return out


def streaminfo_md5(stream: bytes) -> bytes:
    """The MD5 of a FLAC stream's STREAMINFO (the stream's first block)."""
    if stream[:4] != b"fLaC" or stream[4] & 0x7F != 0:
        raise ValueError("no STREAMINFO first")
    return stream[8 + 18: 8 + 34]


def pcm_md5(pcm: np.ndarray, bits: int) -> bytes:
    """The MD5 FLAC's STREAMINFO holds for the samples ``pcm`` [C, n]:
    interleaved, little-endian, ``bits / 8`` bytes a sample."""
    import hashlib

    inter = np.ascontiguousarray(pcm.T).reshape(-1).astype("<i4")
    nbytes = (bits + 7) // 8
    return hashlib.md5(inter.view(np.uint8).reshape(-1, 4)[:, :nbytes].tobytes()).digest()
