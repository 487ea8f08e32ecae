"""In-repo AAC-LC fixtures for the port's tests and ``chip_smoke.py``.

Six synthetic 48 kHz stereo clips, about 4 s each, encoded at 96 kbps
and committed as ADTS files under ``tests/data/torch_port/``. The
content mix covers the decode paths of the v4 wire: PNS noise bands,
M/S, intensity, EIGHT_SHORT transients and TNS filters. Every AU is
v4-clean (a single-AU v4 parse reports no overflow).

This module reads the fixtures and cuts them into lanes. The clips are
made on the test side (``tests/torch_port_helpers.py``, with the JAX
package's FFmpeg-linked ``AacEncoder``), from the repository's root::

    PYTHONPATH=. python tests/torch_port_helpers.py aac
"""
from __future__ import annotations

from pathlib import Path
from typing import List

from soundkit_tpu_torch.codecs.aac_lc import AdtsStream

FIXTURE_DIR = Path(__file__).resolve().parents[2] / "tests" / "data" / "torch_port"
CLIPS = ("noise_pad", "castanets", "chords", "speech_like", "drums", "sweep_pan")


def split_adts(data: bytes) -> List[bytes]:
    """Whole ADTS frames (headers kept) of a synced ADTS stream."""
    frames = []
    off = 0
    while off + 7 <= len(data):
        if data[off] != 0xFF or (data[off + 1] & 0xF6) != 0xF0:
            raise ValueError(f"ADTS sync lost at byte {off}")
        n = ((data[off + 3] & 3) << 11) | (data[off + 4] << 3) | (data[off + 5] >> 5)
        frames.append(data[off : off + n])
        off += n
    return frames


def load_clips(directory: Path = FIXTURE_DIR) -> List[List[bytes]]:
    """ADTS frames of every committed clip, in ``CLIPS`` order."""
    return [split_adts((directory / f"{name}.aac").read_bytes()) for name in CLIPS]


def clip_aus(clips: List[List[bytes]]) -> List[List[bytes]]:
    """Raw AUs (ADTS headers stripped) of every clip's frames."""
    return [AdtsStream().push(b"".join(frames)) for frames in clips]


def lane_frame(clips: List[List[bytes]], lane: int, t: int) -> bytes:
    """Frame (or AU) ``t`` of smoke lane ``lane``: the lane plays clip
    ``lane mod len(clips)`` from frame ``lane // len(clips)``, one frame
    per batch, wrapping at the clip's end. Each (clip, offset) pair is
    distinct while lanes / clips stays below the shortest clip's length."""
    frames = clips[lane % len(clips)]
    return frames[(lane // len(clips) + t) % len(frames)]


def lane_streams(clips: List[List[bytes]], num_lanes: int, n_frames: int) -> List[bytes]:
    """ADTS bytes of ``n_frames`` frames for each of ``num_lanes`` smoke lanes."""
    return [b"".join(lane_frame(clips, i, t) for t in range(n_frames)) for i in range(num_lanes)]


def batch_aus(clip_aus: List[List[bytes]], num_lanes: int, t: int) -> List[bytes]:
    """Raw AUs of batch ``t`` across ``num_lanes`` smoke lanes."""
    return [lane_frame(clip_aus, i, t) for i in range(num_lanes)]
