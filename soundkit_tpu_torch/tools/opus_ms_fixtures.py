"""In-repo multistream Ogg Opus fixtures for the port's tests and
``chip_smoke.py``, committed under ``tests/data/torch_port/opus_ms/``.

Six seeded 48 kHz clips of 0.6-1 s by libopus's multistream encoders,
muxed one packet a page:

- ``surround51``: 5.1, mapping family 1, by the surround encoder in its
  audio application at 256 kbit/s (4 streams, 2 coupled, the LFE stream
  among them), pre-skip the encoder's lookahead;
- ``surround71``: 7.1, family 1, the surround encoder at 384 kbit/s;
- ``three_40ms``: three channels, family 1, 160 kbit/s, packets of 40,
  60 and 20 ms with VBR switched on and off, so that the self-delimited
  streams carry code 0, 1, 2 and 3 packets and the last stream padded
  code 3 ones;
- ``ambisonic_foa``: first-order ambisonics, family 2, four mono
  streams, 192 kbit/s;
- ``voip255``: family 255, the VoIP application at 64 kbit/s, a coupled
  stream forced to hybrid FB and a mono one to SILK WB; its table
  ``[255, 0, 1, 2, 2]`` leaves the first output silent and copies the
  mono stream to the last two (the silent entry comes first: after the
  coupled stream's first channel libavcodec would steal that channel's
  output, see ``codecs/opus_multistream.py``);
- ``surround51_gain``: 5.1 at 192 kbit/s with a pre-skip of 1500 and an
  output gain of -1536 (Q7.8 dB).

Each family-1 and family-2 input channel carries a tone of its own
(:data:`TONES`, the LFE's :data:`LFE_TONE`) under noise bursts; the VoIP
clip a synthetic voice a channel. ``index.json`` holds each clip's file,
SHA-256, head fields (channels, family, streams, coupled, table,
pre-skip, output gain), encoder settings, packet lengths, the TOC codes
each stream's packets use, and the frame count and SHA-256 of the
float32 PCM that the JAX package's ``OggOpusDecoder`` (libavcodec) gives
for it. ``reference_pcm.npz`` keeps that PCM whole for :data:`SMOKE` and
its first :data:`REFERENCE_FRAMES` frames for the others, for
``chip_smoke.py``, where no JAX runs.

The clips are made on the test side (``tests/torch_port_helpers.py``;
needs the JAX package and libopus), from the repository's root::

    PYTHONPATH=. JAX_PLATFORMS=cpu python tests/torch_port_helpers.py opus_ms
"""
from __future__ import annotations

import hashlib
import json
from pathlib import Path
from typing import Dict, List, Sequence, Tuple

import numpy as np

FIXTURE_DIR = Path(__file__).resolve().parents[2] / "tests" / "data" / "torch_port" / "opus_ms"
CLIPS = ("surround51", "surround71", "three_40ms", "ambisonic_foa", "voip255",
         "surround51_gain")
#: the clip ``chip_smoke.py`` lengthens, kept whole in ``reference_pcm.npz``
SMOKE = "surround51"
#: frames of the JAX package's decode kept for the other clips
REFERENCE_FRAMES = 7200
#: a family-1 / family-2 input channel's tone in Hz, by its Vorbis index,
#: and the LFE's (a whole number of cycles in 0.1 s)
TONES = (330, 550, 770, 990, 1210, 1430, 1650, 1870)
LFE_TONE = 60


def load_index(directory: Path = FIXTURE_DIR) -> Dict[str, dict]:
    return json.loads((directory / "index.json").read_text())


def sha256(data: bytes) -> str:
    return hashlib.sha256(data).hexdigest()


def clip_bytes(name: str, directory: Path = FIXTURE_DIR) -> bytes:
    return (directory / load_index(directory)[name]["file"]).read_bytes()


def head_and_packets(name: str, directory: Path = FIXTURE_DIR) -> Tuple[bytes, List[bytes]]:
    """(OpusHead, packets) of clip ``name``."""
    from soundkit_tpu_torch.codecs.opus import OggOpusDemuxer

    dm = OggOpusDemuxer()
    packets = dm.push(clip_bytes(name, directory))
    return dm.head.raw, packets


def reference_pcm(name: str, directory: Path = FIXTURE_DIR) -> np.ndarray:
    """The JAX package's float32 PCM of clip ``name``, interleaved: whole
    for :data:`SMOKE`, its first :data:`REFERENCE_FRAMES` frames else."""
    with np.load(directory / "reference_pcm.npz") as z:
        return z[name]


def ogg_stream(head: bytes, packets: Sequence[bytes], serial: int = 7) -> bytes:
    """An Ogg Opus stream of ``head``, an OpusTags page and one page a
    packet, each page's granule position the samples decoded by its end."""
    import struct

    from soundkit_tpu_torch.codecs.opus_multistream import packet_samples
    from soundkit_tpu_torch.demux.ogg import build_ogg_page

    tags = b"OpusTags" + struct.pack("<I", 2) + b"sk" + struct.pack("<I", 0)
    pages = [build_ogg_page([head], serial, 0, 0, header_type=2),
             build_ogg_page([tags], serial, 1, 0)]
    granule = 0
    for i, p in enumerate(packets):
        granule += packet_samples(p)
        pages.append(build_ogg_page([p], serial, 2 + i, granule))
    return b"".join(pages)


def long_stream(name: str, seconds: float, directory: Path = FIXTURE_DIR) -> Tuple[bytes, float]:
    """(bytes, seconds of audio): clip ``name``'s packets repeated until
    the stream lasts at least ``seconds``, behind the clip's head. Its
    decode begins with the clip's."""
    from soundkit_tpu_torch.codecs.opus_multistream import packet_samples

    head, packets = head_and_packets(name, directory)
    clip = sum(packet_samples(p) for p in packets)
    reps = max(1, -(-int(seconds * 48000) // clip))
    return ogg_stream(head, packets * reps), reps * clip / 48000
