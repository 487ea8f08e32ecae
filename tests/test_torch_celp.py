"""Port parity of the owned G.729 and AMR-NB decoders on the CPU, against
the JAX package's decode of the same streams (libavcodec behind its
framing), on the synthesized clips of ``tools/celp_fixtures.py``.

- G.729 (libavcodec's integer decoder): bit for bit in int16 on every
  clip, whole and in pushes of 1, 7 and 313 bytes, erased frames, failed
  parities and trailing partial frames included.
- AMR-NB (libavcodec's float decoder): >= 90 dB in float32 on every clip,
  all eight modes and a mode switch every frame; the int16 worst
  difference held at what was measured. The port follows libavcodec's
  float operations in their order, so both read exact (inf dB, 0 LSB)
  here; a frame that crossed one of libavcodec's decision thresholds on
  one side only would be named in ``THRESHOLD_FLIPS`` and left out of its
  clip's bar. None is.
- 140 seeded random streams a codec beyond the clips
  (``torch_port_helpers.celp_random_sweep``): equal in float32.
- The edge frames give the JAX package's sample count, push by push:
  SID and NO_DATA nothing, quality bit 0 and TOC bit 7 a frame, FT 9-14
  a byte of resync, an erased G.729 frame its 80 samples.
- The tables: each generated header equals its committed npz, and each
  npz a fresh extraction from ``libavcodec.a`` (skipped where it is not).
"""
import shutil
from pathlib import Path

import numpy as np
import pytest

from soundkit_tpu.codecs import telephony as jax_tel
from soundkit_tpu_torch.codecs import telephony
from soundkit_tpu_torch.tools import celp_fixtures as cf
from soundkit_tpu_torch.tools import extract_celp_tables as ect
from soundkit_tpu_torch.tools import host_codec_fixtures as hcf

from torch_port_helpers import amr_pack, celp_jax_f32, celp_random_sweep, snr_db

#: frames (clip, 160-sample frame index) that cross a libavcodec decision
#: threshold on one side only: none measured
THRESHOLD_FLIPS = {}
#: the worst int16 difference of each AMR-NB clip, as measured
AMR_WORST_LSB = {name: 0 for name in cf.AMR}


def _port(name: str):
    return telephony.G729Decoder() if cf.kind(name) == "g729" else telephony.AmrNbDecoder()


def _jax(name: str):
    return jax_tel.G729Decoder() if cf.kind(name) == "g729" else jax_tel.AmrNbDecoder()


def _decode(dec, data: bytes, chunk: int = 0) -> np.ndarray:
    parts = [dec.decode_f32(data[i:i + chunk]) for i in range(0, len(data), chunk)] if chunk \
        else [dec.decode_f32(data)]
    return np.concatenate(parts + [dec.flush()])


def _held(name: str, got: np.ndarray, want: np.ndarray) -> None:
    """The clip's bar: G.729 bit for bit, AMR-NB >= 90 dB float32 and its
    worst int16 difference, the named threshold flips left out."""
    assert got.shape == want.shape and got.dtype == want.dtype == np.float32
    if cf.kind(name) == "g729":
        np.testing.assert_array_equal(telephony.f32_to_i16(got), jax_tel.f32_to_i16(want))
        return
    keep = np.ones(len(got), bool)
    for f in THRESHOLD_FLIPS.get(name, ()):
        keep[160 * f:160 * (f + 1)] = False
    assert snr_db(got[keep], want[keep]) >= 90.0
    worst = np.abs(telephony.f32_to_i16(got[keep]).astype(np.int32)
                   - jax_tel.f32_to_i16(want[keep]).astype(np.int32)).max()
    assert worst <= AMR_WORST_LSB[name]


@pytest.mark.parametrize("name", cf.CLIPS)
def test_clip_matches_the_jax_package(name):
    data = hcf.clip_bytes(name)
    got = _decode(_port(name), data)
    want = celp_jax_f32(name)
    _held(name, got, want)
    assert len(got) == cf.decoded_frames(name) * (80 if cf.kind(name) == "g729" else 160)
    np.testing.assert_array_equal(telephony.f32_to_i16(got), hcf.reference_pcm(name))
    assert np.abs(got).max() > 0.01


@pytest.mark.parametrize("chunk", [1, 7, 313])
@pytest.mark.parametrize("name", ["g729_random", "g729_edges", "amrnb_random", "amrnb_switch",
                                  "amrnb_edges", "amrnb_nomagic"])
def test_chunked_pushes_decode_as_whole(name, chunk):
    """Pushes of 1, 7 and 313 bytes (frames, TOC bytes and the magic split
    across pushes) decode to the whole clip's decode, held to the JAX
    package's whole decode at the clip's bar."""
    data = hcf.clip_bytes(name)
    got = _decode(_port(name), data, chunk)
    np.testing.assert_array_equal(got, _decode(_port(name), data))
    _held(name, got, celp_jax_f32(name))


@pytest.mark.parametrize("name", ["g729_edges", "amrnb_edges", "amrnb_nomagic"])
def test_edge_frames_give_the_jax_packages_sample_counts(name):
    """Byte by byte, each push gives as many samples as the JAX package's
    push: the frames libavcodec refuses give none, a resync byte none, an
    erased G.729 frame its 80."""
    data = hcf.clip_bytes(name)
    port, jax = _port(name), _jax(name)
    got = [len(port.decode_f32(data[i:i + 1])) for i in range(len(data))]
    want = [len(jax.decode_f32(data[i:i + 1])) for i in range(len(data))]
    assert got == want
    assert len(port.flush()) == len(jax.flush()) == 0


def _one_frame(frame: bytes, prime: bytes) -> tuple:
    """The samples one AMR-NB frame gives after ``prime`` in each package."""
    out = []
    for dec in (telephony.AmrNbDecoder(), jax_tel.AmrNbDecoder()):
        dec.decode_f32(cf.AMR_MAGIC + prime)
        out.append(len(dec.decode_f32(frame)))
    return tuple(out)


@pytest.mark.parametrize("case", ["sid", "no_data", "quality_0", "bit7", "ft9", "ft14"])
def test_amr_edge_frame(case):
    prime = amr_pack(7, {}) * 2
    speech = amr_pack(5, {10: 90, 36: 30, 62: 90, 88: 30})
    frame = {"sid": bytes([(8 << 3) | 4]) + bytes(range(5)),
             "no_data": bytes([(15 << 3) | 4]),
             "quality_0": bytes([speech[0] & ~4]) + speech[1:],
             "bit7": bytes([speech[0] | 0x80]) + speech[1:],
             "ft9": bytes([(9 << 3) | 4]) + speech,
             "ft14": bytes([(14 << 3) | 4]) + speech}[case]
    want = {"sid": 0, "no_data": 0}.get(case, 160)
    assert _one_frame(frame, prime) == (want, want)


def test_g729_erasure_and_partial_frame():
    """An all-zero frame decodes (libavcodec's erasure) to 80 samples in
    both packages, equal; 9 trailing bytes wait for their frame."""
    speech = hcf.clip_bytes("g729_speech")[:200]
    data = speech + bytes(30) + speech[:9]
    got, want = _decode(telephony.G729Decoder(), data), _decode(jax_tel.G729Decoder(), data)
    assert len(got) == len(want) == 23 * 80
    np.testing.assert_array_equal(telephony.f32_to_i16(got), jax_tel.f32_to_i16(want))


@pytest.mark.parametrize("codec", ["g729", "amrnb"])
def test_generated_header_equals_the_committed_npz(codec):
    assert ect.HEADERS[codec].read_text() == ect.header_text(codec, ect.load(codec))


@pytest.mark.parametrize("codec", ["g729", "amrnb"])
def test_npz_equals_a_fresh_extraction(codec):
    if not (Path(ect.ARCHIVE).is_file() and all(shutil.which(t) for t in
                                                 ("ar", "objcopy", "objdump", "nm", "g++"))):
        pytest.skip("libavcodec.a or its binutils are not on this machine")
    fresh = ect.extract()[codec]
    committed = ect.load(codec)
    assert list(fresh) == list(committed)
    for k in committed:
        assert fresh[k].dtype == committed[k].dtype and np.array_equal(fresh[k], committed[k]), k


def test_long_stream_decodes_from_the_clip():
    """A smoke stream repeats the clip's frames; its decode begins with the
    clip's (the reference the card's run is held to)."""
    for kind, name in cf.SMOKE.items():
        data, seconds = hcf.long_stream(name, 10.0)
        assert seconds >= 10.0
        got = telephony.f32_to_i16(_decode(_port(name), data))
        assert len(got) == round(seconds * 8000)
        ref = hcf.reference_pcm(name)
        np.testing.assert_array_equal(got[:len(ref)], ref)


@pytest.mark.parametrize("codec", ["g729", "amrnb"])
def test_seeded_random_streams_match_the_jax_package(codec):
    """140 seeded random streams a codec beyond the committed clips
    (``torch_port_helpers.celp_random_sweep``): G.729 bit for bit, AMR-NB
    at its 90 dB bar and, as measured, equal in float32 (0 LSB)."""
    r = celp_random_sweep(codec)
    assert r["streams"] == 140 and r["unequal"] == 0 and r["worst_lsb"] == 0
    assert r["worst_snr_db"] >= 90.0
