"""Port parity of the owned host codecs on the CPU: GSM 06.10 (standard
and WAV49), AC-3, Ogg Speex (NB, WB, UWB, in-band stereo) and AIFF /
AIFF-C against the JAX package, bit for bit, on the committed clips of
``tests/data/torch_port/host_codecs`` (``tools/host_codec_fixtures.py``):
the decoders alone, whole and chunked, then ``DecodePipeline`` by
detection and by explicit spawn in chunks of 4096 and 313 bytes, and
``simple.MusicDecoder``. An AIFF-C file's µ-law / A-law decodes through
the port's G.711 (K3's plain version on the CPU). AMR-NB and G.729
decode through the owned decoders where the JAX package opens libavcodec
(``tests/test_torch_celp.py``). The stated departure raises: a Speex
header outside the owned modes (libavcodec in the JAX package)."""
import struct

import numpy as np
import pytest

from soundkit_tpu.codecs import ac3_core as jax_ac3
from soundkit_tpu.codecs import aiff as jax_aiff
from soundkit_tpu.codecs import speex as jax_speex
from soundkit_tpu.codecs import telephony as jax_tel
from soundkit_tpu.core.audio_types import AudioData as JaxAudioData
from soundkit_tpu.pipeline import decode_pipeline as jax_dp
from soundkit_tpu_torch import simple
from soundkit_tpu_torch.codecs import ac3_core, aiff, speex, telephony
from soundkit_tpu_torch.core.audio_types import AudioData
from soundkit_tpu_torch.pipeline import decode_pipeline as dp
from soundkit_tpu_torch.pipeline.output_options import DecodeOptions, UnsupportedFormat
from soundkit_tpu_torch.tools import host_codec_fixtures as hcf
from soundkit_tpu_torch.utils.device import KernelLaunchError

from torch_port_helpers import jax_host_decode

INDEX = hcf.load_index()


def _chunks(data: bytes, step: int):
    return [data[i:i + step] for i in range(0, len(data), step)]


def _fields(outs):
    return [(o.sampling_rate, o.channel_count, o.bits_per_sample, o.audio_format.value, o.data)
            if isinstance(o, (AudioData, JaxAudioData)) else type(o).__name__ for o in outs]


# ---------------------------------------------------------------------------
# the decoders alone
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name,variant", [("gsm_standard", "STANDARD"),
                                          ("gsm_wav49", "MICROSOFT")])
def test_gsm_decoder_matches_jax(name, variant):
    """Whole, and in 313-byte pushes (frames split across pushes), equal
    to the JAX package's decode and to each other."""
    data = hcf.clip_bytes(name)
    port = telephony.GsmDecoder(telephony.GsmVariant[variant]).decode_i16(data)
    want = jax_tel.GsmDecoder(jax_tel.GsmVariant[variant]).decode_i16(data)
    np.testing.assert_array_equal(port, want)
    dec = telephony.GsmDecoder(telephony.GsmVariant[variant])
    chunked = np.concatenate([dec.decode_i16(c) for c in _chunks(data, 313)])
    np.testing.assert_array_equal(chunked, port)
    assert port.dtype == np.int16 and len(port) == 16000 and np.abs(port).max() > 1000
    frame = {"STANDARD": 33, "MICROSOFT": 65}[variant]
    assert dec.frame_bytes == frame and len(data) % frame == 0


def test_gsm_decoder_raises_like_jax_on_a_bad_frame():
    bad = bytes(33)  # the signature nibble of a standard frame is 0xD
    with pytest.raises(ValueError, match="bad GSM frame signature"):
        jax_tel.GsmDecoder().decode_i16(bad)
    with pytest.raises(ValueError, match="bad GSM frame signature"):
        telephony.GsmDecoder().decode_i16(bad)


@pytest.mark.parametrize("name", hcf.AC3)
def test_ac3_decoder_matches_jax(name):
    """The owned A/52 core bit for bit (float64 PCM), whole and in
    313-byte pushes, and the int16 wrapper; ``ac3_blksw`` holds short
    blocks."""
    data = hcf.clip_bytes(name)
    port, ref = ac3_core.Ac3Decoder(), jax_ac3.Ac3Decoder()
    got, want = port.decode(data), ref.decode(data)
    assert got.dtype == want.dtype and got.shape == want.shape and got.size > 0
    np.testing.assert_array_equal(got, want)
    assert (port.sample_rate, port.channels) == (ref.sample_rate, ref.channels) == \
        (48000, INDEX[name]["channels"])
    dec = ac3_core.Ac3Decoder()
    np.testing.assert_array_equal(np.concatenate([dec.decode(c) for c in _chunks(data, 313)]), got)
    np.testing.assert_array_equal(telephony.Ac3Decoder().decode_i16(data),
                                  jax_tel.Ac3Decoder().decode_i16(data))
    if name == "ac3_blksw":
        probe = ac3_core.Ac3Decoder()
        probe.decode_frame(data[:INDEX[name]["frame_bytes"]])
        assert probe._blk_bitpos and np.abs(got).max() > 0.01


@pytest.mark.parametrize("name", hcf.SPEEX)
def test_speex_decoder_matches_jax(name):
    """NB, WB and UWB mono and NB in-band stereo: float32 PCM bit for
    bit, whole and in 313-byte pushes (pages split across pushes)."""
    data = hcf.clip_bytes(name)
    port, ref = speex.SpeexDecoder(), jax_speex.SpeexDecoder()
    got, want = port.decode_f32(data), ref.decode_f32(data)
    assert ref._av is None and port._av is None  # the owned path on both sides
    assert got.dtype == want.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    e = INDEX[name]
    assert (port.sample_rate, port.channels, port.mode) == (ref.sample_rate, ref.channels, ref.mode)
    assert (port.sample_rate, port.channels) == (e["rate"], e["channels"])
    dec = speex.SpeexDecoder()
    np.testing.assert_array_equal(np.concatenate([dec.decode_f32(c) for c in _chunks(data, 313)]),
                                  got)
    np.testing.assert_array_equal(speex.SpeexDecoder().decode_i16(data),
                                  jax_speex.SpeexDecoder().decode_i16(data))
    if port.channels == 2:
        lr = got.reshape(-1, 2)
        assert np.abs(lr[:, 0] - lr[:, 1]).max() > 0.01  # the intensity stereo separates them


def _speex_with_header(mode: int, channels: int) -> bytes:
    from soundkit_tpu_torch.demux.ogg import OggPacketizer

    packets = [p for p, _g in OggPacketizer().push(hcf.clip_bytes("speex_nb"))]
    head = bytearray(packets[0])
    struct.pack_into("<I", head, 40, mode)
    struct.pack_into("<I", head, 48, channels)
    return hcf._ogg_speex(bytes(head), packets[1], packets[2:6])


@pytest.mark.parametrize("mode,channels", [(3, 1), (0, 3)])
def test_speex_header_outside_the_owned_modes_raises(mode, channels):
    """A stated departure: the JAX package hands such a header to
    libavcodec (``codecs/speex.py:61``); the port raises, and its pipeline
    reports ``UnsupportedFormat``."""
    data = _speex_with_header(mode, channels)
    with pytest.raises(UnsupportedFormat, match="libavcodec"):
        speex.SpeexDecoder().decode_f32(data)
    core = dp.StreamDecoder(device="cpu")
    outs = core.process(data) + core.process(b"")
    assert [type(o).__name__ for o in outs] == ["UnsupportedFormat"]


@pytest.mark.parametrize("name", hcf.AIFF)
def test_aiff_decoder_matches_jax(name):
    """Every AIFF / AIFF-C variant: the container decode and the
    EOF-buffered adapter, equal to the JAX package's AudioData."""
    data = hcf.clip_bytes(name)
    got = aiff.decode_aiff_container(data, "cpu")
    want = jax_aiff.decode_aiff_container(data)
    assert _fields([got]) == _fields([want])
    adapter = aiff.AiffAdapter("cpu")
    outs = [o for c in _chunks(data, 313) for o in adapter.process(c)] + adapter.flush()
    assert _fields(outs) == _fields([want])
    e = INDEX[name]
    assert (got.sampling_rate, got.channel_count, got.bits_per_sample) == \
        (e["rate"], e["channels"], e["bits"])


@pytest.mark.parametrize("name", ["aifc_ulaw", "aifc_alaw"])
def test_aiff_c_g711_decodes_through_k3(name, monkeypatch):
    """An AIFF-C file's codes go to K3's wrapper on the decoder's device
    as one [1, N] lane; a failed launch reaches the caller of the
    pipeline, not a ``DecodingFailed``."""
    from soundkit_tpu_torch.ops import companding

    calls = []
    plain = companding.g711_decode

    def spy(codes, is_alaw, counts=None):
        calls.append((tuple(codes.shape), int(is_alaw[0]), codes.device.type))
        return plain(codes, is_alaw, counts)

    monkeypatch.setattr(companding, "g711_decode", spy)
    data = hcf.clip_bytes(name)
    got = aiff.decode_aiff_container(data, "cpu")
    assert calls == [((1, len(got.data) // 2), int(name == "aifc_alaw"), "cpu")]

    def fail(*args, **kwargs):
        raise KernelLaunchError("g711_decode: CUDA launch failed with cudaError 98")

    monkeypatch.setattr(companding, "g711_decode", fail)
    core = dp.StreamDecoder(device="cpu")
    assert core.process(data) == []  # buffered to EOF
    with pytest.raises(KernelLaunchError):
        core.process(b"")


@pytest.mark.parametrize("factory", ["make_amr_adapter", "make_g729_adapter", "AmrNbDecoder",
                                     "G729Decoder"])
def test_amr_nb_and_g729_raise(factory):
    """AMR-NB and G.729 (refused by the earlier slices; the name is
    theirs) decode through the owned decoders where the JAX package opens
    libavcodec: each factory's decode of a clip, in 313-byte pushes, equals
    the JAX package's (``tests/test_torch_celp.py`` holds every clip)."""
    clip = "g729_edges" if "729" in factory else "amrnb_edges"
    data = hcf.clip_bytes(clip)
    port, ref = getattr(telephony, factory)(), getattr(jax_tel, factory)()
    if factory.startswith("make_"):
        got = [o for c in _chunks(data, 313) for o in port.process(c)] + port.flush()
        want = [o for c in _chunks(data, 313) for o in ref.process(c)] + ref.flush()
        assert _fields(got) == _fields(want) and got
        assert hcf.sha256(b"".join(o.data for o in got)) == INDEX[clip]["sha256"]
        return
    got = np.concatenate([port.decode_i16(c) for c in _chunks(data, 313)])
    np.testing.assert_array_equal(got, ref.decode_i16(data))
    assert len(port.flush()) == len(ref.flush()) == 0


def test_amr_nb_frame_lengths_equal_the_jax_package():
    for toc in range(256):
        assert telephony.amr_nb_frame_len(toc) == jax_tel.amr_nb_frame_len(toc)


# ---------------------------------------------------------------------------
# through DecodePipeline and the simple API
# ---------------------------------------------------------------------------

PIPELINE_SPAWNS = {
    "detect": lambda: dp.DecodePipeline.spawn(device="cpu"),
    "alac": lambda: dp.DecodePipeline.spawn_alac(device="cpu"),
    "gsm_standard": lambda: dp.DecodePipeline.spawn_gsm(device="cpu"),
    "gsm_microsoft": lambda: dp.DecodePipeline.spawn_gsm(
        telephony.GsmVariant.MICROSOFT, device="cpu"),
}
PIPELINE_CLIPS = ("gsm_standard", "gsm_wav49", "ac3_stereo", "ac3_51", "speex_nb", "speex_wb",
                  "speex_uwb", "speex_nb_stereo", "alac_caf", "alac_mp4", "aiff_24", "aifc_fl64",
                  "aifc_ulaw", "aifc_alaw")


@pytest.mark.parametrize("chunk", [4096, 313])
@pytest.mark.parametrize("name", PIPELINE_CLIPS)
def test_pipeline_decodes_like_the_jax_package(name, chunk):
    """The threaded pipeline, by detection (AIFF, ALAC in MP4, AC-3, Ogg
    Speex) or by its spawn (GSM, ALAC in CAF), against the JAX package's
    ``StreamDecoder`` on the whole clip: every frame's rate, channels,
    bits and bytes, and the PCM's SHA-256 in the index."""
    data = hcf.clip_bytes(name)
    e = INDEX[name]
    handle = PIPELINE_SPAWNS[e["spawn"]]()
    drained = []
    for c in _chunks(data, chunk):
        handle.send_blocking(c, drained)
    handle.send_blocking(b"", drained)
    outs = drained + handle.recv_all(timeout=120)
    assert outs and all(isinstance(o, AudioData) for o in outs), _fields(outs)[:3]
    pcm = b"".join(o.data for o in outs)
    assert hcf.sha256(pcm) == e["sha256"] and len(pcm) == e["pcm_bytes"]
    want = jax_host_decode(name, data, e["spawn"])
    assert {_fields([o])[0][:4] for o in outs} == {_fields([o])[0][:4] for o in want}
    assert pcm == b"".join(o.data for o in want)


@pytest.mark.parametrize("name", ["gsm_standard", "gsm_wav49", "alac_caf"])
def test_explicit_spawns_chunk_like_the_jax_stream_decoder(name):
    """GSM and CAF (not detected): the port's synchronous core with the
    spawn's adapter gives the JAX core's outputs frame for frame."""
    from soundkit_tpu.codecs.containers import AlacAdapter as JaxAlac
    from soundkit_tpu.pipeline.output_options import DecodeOptions as JaxOptions
    from soundkit_tpu_torch.codecs.containers import AlacAdapter

    data = hcf.clip_bytes(name)
    if name == "alac_caf":
        port, ref = AlacAdapter(), JaxAlac()
    else:
        variant = "STANDARD" if name == "gsm_standard" else "MICROSOFT"
        port = telephony.make_gsm_adapter(telephony.GsmVariant[variant])
        ref = jax_tel.make_gsm_adapter(jax_tel.GsmVariant[variant])
    a = dp.StreamDecoder(DecodeOptions(), port, "cpu")
    b = jax_dp.StreamDecoder(JaxOptions(), ref)
    got = [o for c in _chunks(data, 313) for o in a.process(c)] + a.process(b"")
    want = [o for c in _chunks(data, 313) for o in b.process(c)] + b.process(b"")
    assert _fields(got) == _fields(want) and got


@pytest.mark.parametrize("fmt,name", [("speex", "speex_wb"), ("alac", "alac_mp4"),
                                      ("aiff", "aiff_16"), ("ac3", "ac3_mono")])
def test_music_decoder_new_with_format_decodes(fmt, name):
    data = hcf.clip_bytes(name)
    dec = simple.MusicDecoder.new_with_format(fmt, device="cpu")
    frames = [f for c in _chunks(data, 4096) for f in dec.push(c)] + dec.flush()
    ref = jax_dp.StreamDecoder()
    want = [o for c in _chunks(data, 4096) for o in ref.process(c)] + ref.process(b"")
    assert b"".join(f.pcm for f in frames) == b"".join(o.data for o in want)
    assert {(f.sample_rate, f.channels, f.bits) for f in frames} == \
        {(o.sampling_rate, o.channel_count, o.bits_per_sample) for o in want}


def test_host_codec_fixtures_equal_a_regeneration(tmp_path):
    """The generator (on the test side, with the JAX package's
    libavcodec-backed encoders and decoders) makes the committed clips and
    their index byte for byte, and the same reference PCM (the ``.npz``
    archive's member timestamps aside): the float-decoded clips the smoke
    lengthens and, since they were added, every G.729 / AMR-NB clip."""
    from soundkit_tpu_torch.tools import celp_fixtures
    from torch_port_helpers import generate_host_codec_fixtures

    generate_host_codec_fixtures(tmp_path)
    names = sorted(p.name for p in hcf.FIXTURE_DIR.iterdir())
    assert sorted(p.name for p in tmp_path.iterdir()) == names
    for name in names:
        if name.endswith(".npz"):
            with np.load(tmp_path / name) as got, np.load(hcf.FIXTURE_DIR / name) as want:
                assert sorted(got.files) == sorted(want.files) == \
                    sorted(hcf.REFERENCE_PCM + celp_fixtures.CLIPS)
                for k in want.files:
                    np.testing.assert_array_equal(got[k], want[k])
            continue
        assert (tmp_path / name).read_bytes() == (hcf.FIXTURE_DIR / name).read_bytes(), name
