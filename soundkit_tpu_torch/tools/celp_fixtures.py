"""In-repo fixtures of the owned G.729 and AMR-NB decoders for the port's
tests and ``chip_smoke.py``.

No encoder of either codec is at hand, so the streams are synthesized:
both formats have fixed-size frames and the decoders take any payload.
Seeded clips of 2-4 s, committed beside the other host codecs' clips
under ``tests/data/torch_port/host_codecs/`` (entries of its
``index.json``, int16 PCM in its ``reference_pcm.npz``: the JAX package's
decode on the CPU, through libavcodec, since the card's machine has
neither):

- ``g729_random``: uniformly random 10-byte frames (any lag, gain and
  LSF index, saturation and out-of-range lags included) with all-zero
  (erased) frames among them;
- ``g729_speech``: frames packed from slow trajectories: the pitch lag
  drifting over 40-140 samples with its parity bit right, mid-range gain
  indices, LSF indices held for several frames;
- ``g729_edges``: ``g729_speech``'s kind of frames with runs of erased
  frames, frames whose pitch parity fails, and a trailing partial frame;
- ``amrnb_random``: ``#!AMR\\n`` and random payloads in all eight modes
  behind valid TOC bytes;
- ``amrnb_<mode>`` (``4k75`` ... ``12k2``): one mode each, its fields
  packed from slow trajectories through the mode's bit order;
  ``amrnb_switch``: the same, the mode switching every frame;
- ``amrnb_edges``: SID (FT 8) and NO_DATA (FT 15) frames, frames of
  quality bit 0, TOC bytes with bit 7 set, TOC bytes of FT 9-14 (which
  the framing skips a byte at a time) and a trailing partial frame;
  ``amrnb_nomagic``: a stream without the magic, ending in a partial
  frame.

``host_codec_fixtures`` reads them (``clip_bytes``, ``reference_pcm``)
and lengthens a clip through this module's :func:`long_stream`, which
repeats its frames (a long stream's decode begins with the clip's).
The clips are made on the test side (``tests/torch_port_helpers.py``;
needs the JAX package and its libavcodec), from the repository's root::

    PYTHONPATH=. JAX_PLATFORMS=cpu python tests/torch_port_helpers.py celp
"""
from __future__ import annotations

import math
from typing import List, Tuple

from soundkit_tpu_torch.codecs.telephony import AMR_MAGIC, amr_nb_frame_len
from soundkit_tpu_torch.tools import host_codec_fixtures as hcf

G729 = ("g729_random", "g729_speech", "g729_edges")
AMR_MODES = ("4k75", "5k15", "5k9", "6k7", "7k4", "7k95", "10k2", "12k2")
AMR = ("amrnb_random", *(f"amrnb_{m}" for m in AMR_MODES), "amrnb_switch", "amrnb_edges",
       "amrnb_nomagic")
CLIPS = G729 + AMR
#: the clip each kind's smoke stream repeats
SMOKE = {"g729": "g729_speech", "amr_nb": "amrnb_switch"}

G729_FRAME = 10


def kind(name: str) -> str:
    """The fleet kind and spawn of a clip: ``g729`` or ``amr_nb``."""
    return "g729" if name.startswith("g729") else "amr_nb"


def amr_frames(data: bytes) -> Tuple[bool, List[bytes], bytes]:
    """(magic present, the TOC-led frames, the trailing partial frame) of an
    AMR-NB stream, walked as the framing walks it: a TOC byte of no known
    length is skipped alone, as a frame of its own."""
    magic = data[:len(AMR_MAGIC)] == AMR_MAGIC
    pos, frames = len(AMR_MAGIC) if magic else 0, []
    while pos < len(data):
        n = amr_nb_frame_len(data[pos])
        if n is None:
            frames.append(data[pos:pos + 1])
            pos += 1
            continue
        if pos + 1 + n > len(data):
            break
        frames.append(data[pos:pos + 1 + n])
        pos += 1 + n
    return magic, frames, data[pos:]


def decoded_frames(name: str) -> int:
    """The 160- or 80-sample frames of a clip's decode (its index entry)."""
    e = hcf.load_index()[name]
    return e["pcm_bytes"] // 2 // (80 if kind(name) == "g729" else 160)


def long_stream(name: str, seconds: float) -> Tuple[bytes, float]:
    """The clip's whole frames repeated to at least ``seconds`` of audio (a
    G.729 clip's trailing partial frame, an AMR-NB clip's partial frame
    dropped; an AMR-NB clip keeps its magic), and the audio seconds of the
    stream's decode."""
    data = hcf.clip_bytes(name)
    per_clip = decoded_frames(name) * (80 if kind(name) == "g729" else 160) / 8000.0
    reps = max(1, math.ceil(seconds / per_clip))
    if kind(name) == "g729":
        body = data[:len(data) // G729_FRAME * G729_FRAME]
        return body * reps, per_clip * reps
    magic, frames, _tail = amr_frames(data)
    return (AMR_MAGIC if magic else b"") + b"".join(frames) * reps, per_clip * reps
