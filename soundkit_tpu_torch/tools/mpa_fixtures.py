"""In-repo MPEG audio Layer I / II fixtures for the port's tests and
``chip_smoke.py``, committed under ``tests/data/torch_port/mpa/``.

Short seeded clips (a few frames each) of two origins:

- made by the JAX package's ``AvEncoder`` (libavcodec's ``mp2`` and
  ``libtwolame``): MPEG-1 Layer II at 48 / 44.1 / 32 kHz, stereo and mono,
  at bit rates that select each of the four MPEG-1 allocation tables;
  MPEG-2 LSF Layer II at 16 / 22.05 / 24 kHz; one ``libtwolame`` stream.
  These encoders write plain stereo or mono, with no CRC;
- made by a seeded frame writer on the test side (random allocations,
  scalefactors and sample codes within each frame's bits): Layer I
  (MPEG-1 and LSF), joint stereo at each intensity bound (4 / 8 / 12 /
  16, frame by frame), dual channel, CRC-protected frames (and one clip
  with wrong CRC words, which decode all the same), padded frames and
  MPEG-2.5 Layer II.

``index.json`` holds each clip's file, SHA-256, layer, version
(``"1"``, ``"2"``, ``"2.5"``), mode, rate, channels, frame count and
origin, and the sample count and SHA-256 of the float32 PCM that the JAX
package's ``Mp3Decoder`` (libavcodec) gives for it. ``reference_pcm.npz``
keeps that PCM for the clips that ``chip_smoke.py`` lengthens
(:data:`SMOKE`), where no JAX runs. :func:`long_stream` makes a long
stream by repeating a clip's frames; its decode begins with the clip's.

The clips are made on the test side (``tests/torch_port_helpers.py``;
needs the JAX package and FFmpeg's encoders), from the repository's root::

    PYTHONPATH=. JAX_PLATFORMS=cpu python tests/torch_port_helpers.py mpa
"""
from __future__ import annotations

import hashlib
import json
import math
from pathlib import Path
from typing import Dict, List, Tuple

import numpy as np

FIXTURE_DIR = Path(__file__).resolve().parents[2] / "tests" / "data" / "torch_port" / "mpa"
#: the clips that ``chip_smoke.py`` lengthens: Layer II stereo 48 kHz,
#: Layer II LSF mono, Layer I
SMOKE = ("l2_48_stereo_192", "l2_lsf22_mono_64", "l1_48_stereo_384")


def load_index(directory: Path = FIXTURE_DIR) -> Dict[str, dict]:
    return json.loads((directory / "index.json").read_text())


def clip_bytes(name: str, directory: Path = FIXTURE_DIR) -> bytes:
    return (directory / load_index(directory)[name]["file"]).read_bytes()


def reference_pcm(name: str, directory: Path = FIXTURE_DIR) -> np.ndarray:
    """The JAX package's float32 PCM of a :data:`SMOKE` clip, interleaved."""
    with np.load(directory / "reference_pcm.npz") as z:
        return z[name]


def sha256(data: bytes) -> str:
    return hashlib.sha256(data).hexdigest()


def split_frames(data: bytes) -> List[bytes]:
    """A clip of back-to-back frames cut into its frames."""
    from soundkit_tpu_torch.codecs.mpa_layer12 import parse_header

    frames, i = [], 0
    while i < len(data):
        h = parse_header(data, i)
        if h is None:
            raise ValueError(f"no MPEG audio header at byte {i}: {data[i:i + 4].hex()}")
        frames.append(data[i:i + h.frame_size])
        i += h.frame_size
    return frames


def long_stream(name: str, seconds: float, directory: Path = FIXTURE_DIR) -> Tuple[bytes, float]:
    """(bytes, seconds of audio): clip ``name``'s frames repeated until the
    stream lasts at least ``seconds``."""
    e = load_index(directory)[name]
    clip_seconds = e["samples"] / e["channels"] / e["rate"]
    reps = max(1, math.ceil(seconds / clip_seconds))
    return clip_bytes(name, directory) * reps, reps * clip_seconds
